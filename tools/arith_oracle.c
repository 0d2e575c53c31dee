/* Arithmetic-coding conformance oracle for the in-framework T.81
 * Annex D/F/G codec (libultrahdr_dev/jpeg/arith.py + native).
 *
 * Uses the SYSTEM libjpeg (which has C_/D_ARITH_CODING_SUPPORTED) to
 * (a) produce arithmetic-coded JPEG test vectors (sequential SOF9 and
 * progressive SOF10, optional restart intervals) and (b) dump the
 * exact entropy-decoded DCT coefficients of any JPEG, so our decoder
 * can be compared bit-for-bit. Mirrors the role of
 * tools/golden_main.cpp for the JPEG/R pixel path.
 *
 * Build: gcc -O2 tools/arith_oracle.c -ljpeg -o /tmp/arith_oracle
 *
 * Modes:
 *   enc  <raw.bin> <w> <h> <ncomp 1|3> <quality> <prog 0|1> <rst> <out.jpg>
 *        raw.bin = interleaved u8 samples (gray or RGB), row-major.
 *   coef <in.jpg> <out.bin>
 *        out.bin = for each component: i32 ncomp-header first:
 *        [i32 ncomp] then per component [i32 bw, i32 bh] + bh*bw*64
 *        i16 coefficients in JPEG zigzag order.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

static const int ZZ[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

static int do_enc(int argc, char **argv) {
  const char *rawp = argv[2];
  int w = atoi(argv[3]), h = atoi(argv[4]), nc = atoi(argv[5]);
  int q = atoi(argv[6]), prog = atoi(argv[7]), rst = atoi(argv[8]);
  const char *outp = argv[9];
  FILE *fr = fopen(rawp, "rb");
  if (!fr) return 2;
  long need = (long)w * h * nc;
  unsigned char *raw = malloc(need);
  if (fread(raw, 1, need, fr) != (size_t)need) return 3;
  fclose(fr);

  struct jpeg_compress_struct c;
  struct jpeg_error_mgr jerr;
  c.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&c);
  FILE *fo = fopen(outp, "wb");
  if (!fo) return 4;
  jpeg_stdio_dest(&c, fo);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, q, TRUE);
  c.arith_code = TRUE;
  if (prog) jpeg_simple_progression(&c);
  if (rst) c.restart_interval = rst;
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = raw + (long)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(fo);
  free(raw);
  return 0;
}

static int do_coef(int argc, char **argv) {
  FILE *fi = fopen(argv[2], "rb");
  if (!fi) return 2;
  struct jpeg_decompress_struct d;
  struct jpeg_error_mgr jerr;
  d.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&d);
  jpeg_stdio_src(&d, fi);
  jpeg_read_header(&d, TRUE);
  jvirt_barray_ptr *coefs = jpeg_read_coefficients(&d);
  if (!coefs) return 5;
  FILE *fo = fopen(argv[3], "wb");
  int nc = d.num_components;
  fwrite(&nc, 4, 1, fo);
  for (int ci = 0; ci < nc; ci++) {
    jpeg_component_info *comp = d.comp_info + ci;
    int bw = comp->width_in_blocks, bh = comp->height_in_blocks;
    fwrite(&bw, 4, 1, fo);
    fwrite(&bh, 4, 1, fo);
    for (int by = 0; by < bh; by++) {
      JBLOCKARRAY rows = (*d.mem->access_virt_barray)(
          (j_common_ptr)&d, coefs[ci], by, 1, FALSE);
      for (int bx = 0; bx < bw; bx++) {
        short zz[64];
        for (int k = 0; k < 64; k++) zz[k] = rows[0][bx][ZZ[k]];
        fwrite(zz, 2, 64, fo);
      }
    }
  }
  fclose(fo);
  jpeg_finish_decompress(&d);
  jpeg_destroy_decompress(&d);
  fclose(fi);
  return 0;
}

int main(int argc, char **argv) {
  if (argc >= 10 && !strcmp(argv[1], "enc")) return do_enc(argc, argv);
  if (argc >= 4 && !strcmp(argv[1], "coef")) return do_coef(argc, argv);
  fprintf(stderr, "usage: enc raw w h nc q prog rst out | coef in out\n");
  return 1;
}
