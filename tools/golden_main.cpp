// Golden oracle driver for parity testing the JAX rebuild against the
// reference implementation. Lives outside the repo.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <fstream>
#include <chrono>
#include <cmath>
#include "ultrahdr/jpegr.h"
#include "ultrahdr/jpegrutils.h"
#include "ultrahdr/icc.h"
#include "ultrahdr/gainmapmath.h"

using namespace ultrahdr;

static std::vector<uint8_t> readfile(const char* p) {
  std::ifstream f(p, std::ios::binary);
  return std::vector<uint8_t>((std::istreambuf_iterator<char>(f)),
                              std::istreambuf_iterator<char>());
}
static void writefile(const std::string& p, const void* d, size_t n) {
  std::ofstream f(p, std::ios::binary);
  f.write((const char*)d, n);
}

int main(int argc, char** argv) {
  std::string mode = argv[1];
  if (mode == "xmp") {
    // emit XMP strings for given metadata
    ultrahdr_metadata_struct md;
    md.version = "1.0";
    md.maxContentBoost = atof(argv[2]);
    md.minContentBoost = atof(argv[3]);
    md.gamma = 1.0f; md.offsetSdr = 0.0f; md.offsetHdr = 0.0f;
    md.hdrCapacityMin = 1.0f; md.hdrCapacityMax = md.maxContentBoost;
    int secondary_len = atoi(argv[4]);
    std::string p = generateXmpForPrimaryImage(secondary_len, md);
    std::string s = generateXmpForSecondaryImage(md);
    writefile("xmp_primary.bin", p.data(), p.size());
    writefile("xmp_secondary.bin", s.data(), s.size());
    return 0;
  }
  if (mode == "icc") {
    // argv[2]=tf (0 linear,1 hlg,2 pq,3 srgb), argv[3]=gamut(0,1,2)
    auto icc = IccHelper::writeIccProfile(
        (ultrahdr_transfer_function)atoi(argv[2]),
        (ultrahdr_color_gamut)atoi(argv[3]));
    writefile(std::string("icc_") + argv[2] + "_" + argv[3] + ".bin",
              icc->getData(), icc->getLength());
    return 0;
  }
  if (mode == "encode0") {
    // argv: encode0 <p010file> <w> <h> <tf 1=hlg 2=pq> <quality> <out>
    //       [gamut 0=709 1=p3 2=2100]
    auto raw = readfile(argv[2]);
    int w = atoi(argv[3]), h = atoi(argv[4]);
    ultrahdr_uncompressed_struct p010{};
    p010.data = raw.data();
    p010.width = w; p010.height = h;
    p010.colorGamut = argc > 8 ? (ultrahdr_color_gamut)atoi(argv[8])
                               : ULTRAHDR_COLORGAMUT_BT2100;
    p010.luma_stride = w;
    p010.chroma_data = raw.data() + (size_t)w * h * 2;
    p010.chroma_stride = w;
    ultrahdr_compressed_struct dest{};
    std::vector<uint8_t> buf((size_t)w * h * 3 * 2);
    dest.data = buf.data(); dest.maxLength = buf.size();
    JpegR jpegr;
    auto t0 = std::chrono::steady_clock::now();
    status_t st = jpegr.encodeJPEGR(&p010,
        (ultrahdr_transfer_function)atoi(argv[5]), &dest, atoi(argv[6]),
        nullptr);
    auto t1 = std::chrono::steady_clock::now();
    if (st != ULTRAHDR_NO_ERROR) { fprintf(stderr, "encode failed %d\n", st); return 1; }
    fprintf(stdout, "encode_ms=%.3f\n",
            std::chrono::duration<double, std::milli>(t1 - t0).count());
    writefile(argv[7], dest.data, dest.length);
    return 0;
  }
  if (mode == "decode") {
    // argv: decode <jpegr> <outprefix> <fmt 0=f16 3=sdr...> <boost>
    auto blob = readfile(argv[2]);
    ultrahdr_compressed_struct in{};
    in.data = blob.data(); in.length = blob.size(); in.maxLength = blob.size();
    JpegR jpegr;
    jpegr_info_struct info{};
    jpeg_info_struct pinfo, ginfo;
    info.primaryImgInfo = &pinfo; info.gainmapImgInfo = &ginfo;
    if (jpegr.getJPEGRInfo(&in, &info) != ULTRAHDR_NO_ERROR) { fprintf(stderr, "info failed\n"); return 1; }
    size_t w = info.width, h = info.height;
    ultrahdr_uncompressed_struct dest{};
    std::vector<uint8_t> out(w * h * 8);
    dest.data = out.data();
    ultrahdr_output_format fmt = (ultrahdr_output_format)atoi(argv[4]);
    float boost = atof(argv[5]);
    ultrahdr_metadata_struct md{};
    auto t0 = std::chrono::steady_clock::now();
    status_t st = jpegr.decodeJPEGR(&in, &dest, boost, nullptr, fmt, nullptr, &md);
    auto t1 = std::chrono::steady_clock::now();
    if (st != ULTRAHDR_NO_ERROR) { fprintf(stderr, "decode failed %d\n", st); return 1; }
    fprintf(stdout, "decode_ms=%.3f w=%zu h=%zu maxboost=%f minboost=%f\n",
            std::chrono::duration<double, std::milli>(t1 - t0).count(),
            w, h, md.maxContentBoost, md.minContentBoost);
    size_t bpp = (fmt == ULTRAHDR_OUTPUT_HDR_LINEAR) ? 8 : 4;
    writefile(std::string(argv[3]) + ".raw", dest.data, w * h * bpp);
    return 0;
  }
  if (mode == "gengm") {
    // argv: gengm <yuv420file> <p010file> <w> <h> <tf> -> gainmap.bin + meta
    auto sdr = readfile(argv[2]);
    auto hdr = readfile(argv[3]);
    int w = atoi(argv[4]), h = atoi(argv[5]);
    ultrahdr_uncompressed_struct yuv{};
    yuv.data = sdr.data(); yuv.width = w; yuv.height = h;
    yuv.colorGamut = ULTRAHDR_COLORGAMUT_BT709;
    yuv.luma_stride = w;
    yuv.chroma_data = sdr.data() + (size_t)w * h;
    yuv.chroma_stride = w / 2;
    ultrahdr_uncompressed_struct p010{};
    p010.data = hdr.data(); p010.width = w; p010.height = h;
    p010.colorGamut = ULTRAHDR_COLORGAMUT_BT2100;
    p010.luma_stride = w;
    p010.chroma_data = hdr.data() + (size_t)w * h * 2;
    p010.chroma_stride = w;
    ultrahdr_metadata_struct md; md.version = "1.0";
    ultrahdr_uncompressed_struct gm{};
    struct Shim : UltraHdr { using UltraHdr::generateGainMap; }; Shim u;
    auto t0 = std::chrono::steady_clock::now();
    status_t st = u.generateGainMap(&yuv, &p010,
        (ultrahdr_transfer_function)atoi(argv[6]), &md, &gm, false);
    auto t1 = std::chrono::steady_clock::now();
    if (st != ULTRAHDR_NO_ERROR) { fprintf(stderr, "gengm failed %d\n", st); return 1; }
    fprintf(stdout, "gengm_ms=%.3f mw=%zu mh=%zu maxboost=%f\n",
            std::chrono::duration<double, std::milli>(t1 - t0).count(),
            gm.width, gm.height, md.maxContentBoost);
    writefile("gainmap.bin", gm.data, gm.width * gm.height);
    delete[] (uint8_t*)gm.data;
    return 0;
  }
  fprintf(stderr, "unknown mode\n");
  return 1;
}
