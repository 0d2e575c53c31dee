"""Arithmetic-coded JPEG entropy codec tests (T.81 Annex D/F/G).

Self round trips plus bit-exact conformance against the system
libjpeg (tools/arith_oracle.c), which carries the same reference QM
coder the target's libjpeg-turbo uses (jpegdecoderhelper.cpp:422
decodes SOF9/SOF10 transparently through jpeg_read_*)."""

import os
import shutil
import struct
import subprocess

import numpy as np
import pytest

from libultrahdr_dev.jpeg import arith

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = "/tmp/arith_oracle"


def _build_oracle():
    if os.path.exists(ORACLE):
        return True
    if not shutil.which("gcc"):
        return False
    src = os.path.join(REPO, "tools", "arith_oracle.c")
    r = subprocess.run(["gcc", "-O2", src, "-ljpeg", "-o", ORACLE],
                       capture_output=True)
    return r.returncode == 0


needs_oracle = pytest.mark.skipif(not _build_oracle(),
                                  reason="no gcc/libjpeg for oracle")


def _read_coefs(path):
    b = open(path, "rb").read()
    nc, = struct.unpack_from("<i", b, 0)
    off = 4
    out = []
    for _ in range(nc):
        bw, bh = struct.unpack_from("<ii", b, off)
        off += 8
        arr = np.frombuffer(b, "<i2", bh * bw * 64, off).reshape(
            bh, bw, 64)
        off += bh * bw * 128
        out.append(arr)
    return out


def _synth_gray(w, h, seed=1):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1)).astype(
        np.float32)
    img = np.kron(small, np.ones((8, 8), np.float32))[:h, :w]
    return ((img + np.roll(img, 3, 0) + np.roll(img, 3, 1)) / 3).astype(
        np.uint8)


def _rand_blocks(nblocks, seed=0, dcmax=300, acmax=255):
    rng = np.random.default_rng(seed)
    blocks = np.zeros((nblocks, 64), np.int16)
    blocks[:, 0] = rng.integers(-dcmax, dcmax + 1, nblocks)
    for i in range(nblocks):
        pos = rng.integers(1, 64, rng.integers(0, 24))
        blocks[i, pos] = rng.integers(-acmax, acmax + 1, pos.size)
    return blocks


class TestQmCoder:
    def test_raw_bit_roundtrip(self):
        rng = np.random.default_rng(0)
        bits = rng.integers(0, 2, 4000).tolist()
        bits += (rng.random(4000) < 0.95).astype(int).tolist()
        enc = arith.Encoder()
        st = bytearray(1)
        for b in bits:
            enc.encode(st, 0, int(b))
        blob = enc.flush()
        dec = arith.Decoder(blob)
        st2 = bytearray(1)
        assert [dec.decode(st2, 0) for _ in bits] == bits
        # adaptive coding must beat 1 bit/symbol on the biased half
        assert len(blob) < len(bits) // 8

    def test_fixed_state_is_equiprobable(self):
        # state 113 never adapts (T.81: used for AC signs)
        qe, nmps, nlps, sw = arith.QE_TABLE[arith.FIXED_STATE]
        assert (nmps, nlps, sw) == (113, 113, 0)
        assert qe == 0x5A1D

    def test_stuffing_roundtrip(self):
        # drive the encoder towards 0xFF output bytes (long MPS runs
        # produce high bytes) and check stuffed stream still decodes
        enc = arith.Encoder()
        st = bytearray(1)
        bits = ([1] * 2000 + [0]) * 5
        for b in bits:
            enc.encode(st, 0, b)
        blob = enc.flush()
        dec = arith.Decoder(blob)
        st2 = bytearray(1)
        assert [dec.decode(st2, 0) for _ in bits] == bits


class TestSequentialScan:
    @pytest.mark.parametrize("restart", [0, 7, 1])
    def test_roundtrip_interleaved(self, restart):
        mcu_blocks, n_mcus = 6, 25
        comp_ids = np.tile(np.array([0, 0, 0, 0, 1, 2], np.uint8),
                           n_mcus)
        blocks = _rand_blocks(n_mcus * mcu_blocks)
        dc_sel, ac_sel = [0, 1, 1], [0, 1, 1]
        dc_cond = {0: (0, 1), 1: (0, 1)}
        ac_cond = {0: 5, 1: 5}
        data = arith.encode_seq_scan(blocks, comp_ids, dc_sel, ac_sel,
                                     dc_cond, ac_cond, restart,
                                     mcu_blocks)
        out = np.zeros_like(blocks)
        arith.decode_seq_scan(data, out, comp_ids, dc_sel, ac_sel,
                              dc_cond, ac_cond, restart, mcu_blocks)
        assert np.array_equal(blocks, out)

    def test_extreme_coefficients(self):
        blocks = np.zeros((4, 64), np.int16)
        blocks[0, 0] = 2047
        blocks[1, 0] = -2047
        blocks[2, 1] = 1023
        blocks[3, 63] = -1023
        cid = np.zeros(4, np.uint8)
        d = arith.encode_seq_scan(blocks, cid, [0], [0], {0: (0, 1)},
                                  {0: 5}, 0, 1)
        o = np.zeros_like(blocks)
        arith.decode_seq_scan(d, o, cid, [0], [0], {0: (0, 1)}, {0: 5},
                              0, 1)
        assert np.array_equal(blocks, o)

    def test_nondefault_conditioning_roundtrip(self):
        blocks = _rand_blocks(24, seed=3)
        cid = np.zeros(24, np.uint8)
        for cond in [(1, 3), (0, 0), (4, 8)]:
            for kx in (1, 30, 63):
                d = arith.encode_seq_scan(blocks, cid, [0], [0],
                                          {0: cond}, {0: kx}, 0, 1)
                o = np.zeros_like(blocks)
                arith.decode_seq_scan(d, o, cid, [0], [0], {0: cond},
                                      {0: kx}, 0, 1)
                assert np.array_equal(blocks, o), (cond, kx)

    def test_truncated_stream_raises_or_garbage(self):
        # a truncated stream must never hang or crash; the zero feed
        # past the end decodes SOMETHING or raises ArithError
        blocks = _rand_blocks(16, seed=4)
        cid = np.zeros(16, np.uint8)
        d = arith.encode_seq_scan(blocks, cid, [0], [0], {0: (0, 1)},
                                  {0: 5}, 0, 1)
        for cut in (1, len(d) // 2, len(d) - 2):
            o = np.zeros_like(blocks)
            try:
                arith.decode_seq_scan(d[:cut], o, cid, [0], [0],
                                      {0: (0, 1)}, {0: 5}, 0, 1)
            except arith.ArithError:
                pass


@needs_oracle
class TestLibjpegConformance:
    def _enc(self, raw, w, h, nc, q, prog, rst, out):
        raw.tofile("/tmp/arith_t.raw")
        subprocess.run([ORACLE, "enc", "/tmp/arith_t.raw", str(w),
                        str(h), str(nc), str(q), str(prog), str(rst),
                        out], check=True)

    @staticmethod
    def _parse(blob):
        """Minimal marker walk returning (dac, rst, scans) where each
        scan = (ss, se, ah, al, entropy_bytes, comps)."""
        dac, rst, scans = {}, 0, []
        comps = []

        def entropy_end(data, start):
            j = start
            while j < len(data) - 1:
                if (data[j] == 0xFF and data[j + 1] not in (0, 0xFF)
                        and not 0xD0 <= data[j + 1] <= 0xD7):
                    return j
                j += 1
            return len(data)

        i = 2
        while i < len(blob) - 1:
            if blob[i] != 0xFF:
                i += 1
                continue
            m = blob[i + 1]
            if m == 0xD9:
                break
            if m == 0x01 or 0xD0 <= m <= 0xD7:
                i += 2
                continue
            ln = (blob[i + 2] << 8) | blob[i + 3]
            payload = blob[i + 4: i + 2 + ln]
            nxt = i + 2 + ln
            if m == 0xCC:
                p = 0
                while p < len(payload):
                    dac[(payload[p] >> 4, payload[p] & 15)] = \
                        payload[p + 1]
                    p += 2
            elif m in (0xC9, 0xCA):
                comps = [(payload[6 + j * 3], payload[7 + j * 3])
                         for j in range(payload[5])]
            elif m == 0xDD:
                rst = int.from_bytes(payload[:2], "big")
            elif m == 0xDA:
                ns = payload[0]
                sel = [(payload[1 + j * 2], payload[2 + j * 2])
                       for j in range(ns)]
                ss, se = payload[1 + ns * 2], payload[2 + ns * 2]
                a = payload[3 + ns * 2]
                e1 = entropy_end(blob, nxt)
                scans.append((ss, se, a >> 4, a & 15,
                              blob[nxt:e1], sel))
                nxt = e1
            i = nxt
        return dac, rst, scans, comps

    @pytest.mark.parametrize("rst", [0, 4])
    def test_sequential_gray_decode_matches(self, rst, tmp_path):
        w, h = 64, 48
        jp = str(tmp_path / "a.jpg")
        self._enc(_synth_gray(w, h), w, h, 1, 90, 0, rst, jp)
        cf = str(tmp_path / "a.coef")
        subprocess.run([ORACLE, "coef", jp, cf], check=True)
        want = _read_coefs(cf)[0]
        blob = open(jp, "rb").read()
        dac, rst2, scans, _ = self._parse(blob)
        assert rst2 == rst
        (ss, se, ah, al, ent, sel), = scans
        bh, bw = want.shape[:2]
        blocks = np.zeros((bh * bw, 64), np.int16)
        dcv = dac.get((0, 0), 0x10)
        arith.decode_seq_scan(ent, blocks, np.zeros(bh * bw, np.uint8),
                              [0], [0], {0: (dcv & 15, dcv >> 4)},
                              {0: dac.get((1, 0), 5)}, rst, 1)
        assert np.array_equal(blocks.reshape(bh, bw, 64), want)

    def test_progressive_gray_decode_matches(self, tmp_path):
        w, h = 64, 48
        jp = str(tmp_path / "p.jpg")
        self._enc(_synth_gray(w, h, seed=7), w, h, 1, 85, 1, 0, jp)
        cf = str(tmp_path / "p.coef")
        subprocess.run([ORACLE, "coef", jp, cf], check=True)
        want = _read_coefs(cf)[0]
        blob = open(jp, "rb").read()
        dac, rst, scans, _ = self._parse(blob)
        bh, bw = want.shape[:2]
        grid = np.zeros((bh * bw, 64), np.int16)
        cids = np.zeros(bh * bw, np.uint8)
        dcv = dac.get((0, 0), 0x10)
        dc_cond = {0: (dcv & 15, dcv >> 4)}
        kx = dac.get((1, 0), 5)
        assert len(scans) >= 4   # real successive approximation
        for ss, se, ah, al, ent, sel in scans:
            if ss == 0:
                if ah == 0:
                    arith.prog_dc_first(ent, grid, cids, [0], dc_cond,
                                        al, rst, 1)
                else:
                    arith.prog_dc_refine(ent, grid, al, rst, 1)
            elif ah == 0:
                arith.prog_ac_first(ent, grid, kx, ss, se, al, rst)
            else:
                arith.prog_ac_refine(ent, grid, ss, se, al, rst)
        assert np.array_equal(grid.reshape(bh, bw, 64), want)

    @pytest.mark.parametrize("rst", [0, 3])
    def test_libjpeg_decodes_our_encode(self, rst, tmp_path):
        bh, bw = 6, 8
        blocks = _rand_blocks(bh * bw, seed=5, dcmax=200, acmax=100)
        ent = arith.encode_seq_scan(blocks, np.zeros(bh * bw, np.uint8),
                                    [0], [0], {0: (0, 1)}, {0: 5},
                                    rst, 1)

        def mk(m, p):
            return bytes((0xFF, m)) + (len(p) + 2).to_bytes(2, "big") + p

        w, h = bw * 8, bh * 8
        out = b"\xff\xd8"
        out += mk(0xDB, bytes([0]) + bytes(np.ones(64, np.uint8)))
        out += mk(0xC9, bytes([8]) + h.to_bytes(2, "big")
                  + w.to_bytes(2, "big") + bytes([1, 1, 0x11, 0]))
        out += mk(0xCC, bytes([0x00, 0x10, 0x10, 5]))
        if rst:
            out += mk(0xDD, rst.to_bytes(2, "big"))
        out += mk(0xDA, bytes([1, 1, 0x00, 0, 63, 0]))
        out += ent + b"\xff\xd9"
        jp = str(tmp_path / "ours.jpg")
        open(jp, "wb").write(out)
        cf = str(tmp_path / "ours.coef")
        subprocess.run([ORACLE, "coef", jp, cf], check=True)
        got = _read_coefs(cf)[0].reshape(-1, 64)
        assert np.array_equal(got, blocks)

    def test_sequential_color_420_decode_matches(self, tmp_path):
        w, h = 80, 64
        rng = np.random.default_rng(11)
        g = _synth_gray(w, h, seed=2)
        rgb = np.stack([g, np.roll(g, 5, 1),
                        rng.integers(0, 256, (h, w)).astype(np.uint8)],
                       -1)
        jp = str(tmp_path / "c.jpg")
        self._enc(rgb, w, h, 3, 90, 0, 0, jp)
        cf = str(tmp_path / "c.coef")
        subprocess.run([ORACLE, "coef", jp, cf], check=True)
        want = _read_coefs(cf)
        blob = open(jp, "rb").read()
        dac, rst, scans, comps = self._parse(blob)
        (ss, se, ah, al, ent, sel), = scans
        # default libjpeg: luma 2x2, chroma 1x1; table sel 0/1/1
        mcus_x, mcus_y = -(-w // 16), -(-h // 16)
        nblocks = mcus_x * mcus_y * 6
        comp_ids = np.tile(np.array([0, 0, 0, 0, 1, 2], np.uint8),
                           mcus_x * mcus_y)
        blocks = np.zeros((nblocks, 64), np.int16)
        dc_sel = [s >> 4 for _, s in sel]
        ac_sel = [s & 15 for _, s in sel]
        dc_cond = {t: ((dac.get((0, t), 0x10)) & 15,
                       (dac.get((0, t), 0x10)) >> 4) for t in dc_sel}
        ac_cond = {t: dac.get((1, t), 5) for t in ac_sel}
        arith.decode_seq_scan(ent, blocks, comp_ids, dc_sel, ac_sel,
                              dc_cond, ac_cond, rst, 6)
        grid = blocks.reshape(mcus_y, mcus_x, 6, 64)
        luma = grid[:, :, :4, :].reshape(mcus_y, mcus_x, 2, 2, 64)
        luma = luma.transpose(0, 2, 1, 3, 4).reshape(mcus_y * 2,
                                                     mcus_x * 2, 64)
        bh0, bw0 = want[0].shape[:2]
        assert np.array_equal(luma[:bh0, :bw0], want[0])
        for ci in (1, 2):
            bh_, bw_ = want[ci].shape[:2]
            assert np.array_equal(
                grid[:, :, 3 + ci, 0:64].reshape(mcus_y, mcus_x,
                                                 64)[:bh_, :bw_],
                want[ci])


class TestCodecIntegration:
    """decode_jpeg_coefs / encode_jpeg level: SOF9/SOF10 routing, DAC
    parsing, and the arithmetic encode option."""

    def _planes(self, seed=3, h=48, w=64):
        rng = np.random.default_rng(seed)
        return {"y": _synth_gray(w, h, seed),
                "u": rng.integers(96, 160, (h // 2, w // 2)).astype(
                    np.uint8),
                "v": rng.integers(96, 160, (h // 2, w // 2)).astype(
                    np.uint8)}

    @pytest.mark.parametrize("rst", [0, 2])
    def test_arith_encode_matches_huffman_coefs(self, rst):
        from libultrahdr_dev.jpeg import codec
        planes = self._planes()
        a = codec.encode_jpeg(planes, 90, restart_interval=rst,
                              arithmetic=True)
        hj = codec.encode_jpeg(planes, 90, restart_interval=rst)
        ra = codec.decode_jpeg_coefs(a)
        rh = codec.decode_jpeg_coefs(hj)
        for (ga, *_), (gh, *_) in zip(ra.comps, rh.comps):
            assert np.array_equal(ga, gh)
        # entropy layer should also be denser than Huffman here
        assert len(a) < len(hj)

    def test_arith_encode_gray(self):
        from libultrahdr_dev.jpeg import codec
        y = _synth_gray(64, 48, seed=9)
        a = codec.encode_jpeg({"y": y}, 85, arithmetic=True)
        hj = codec.encode_jpeg({"y": y}, 85)
        assert np.array_equal(codec.decode_jpeg_coefs(a).comps[0][0],
                              codec.decode_jpeg_coefs(hj).comps[0][0])

    def test_pil_decodes_our_arith_jpeg(self):
        import io

        from PIL import Image

        from libultrahdr_dev.jpeg import codec
        blob = codec.encode_jpeg(self._planes(), 90, arithmetic=True)
        im = Image.open(io.BytesIO(blob))
        im.load()
        assert im.size == (64, 48)

    def test_full_decode_pixels_close_to_huffman(self):
        from libultrahdr_dev.jpeg import codec
        planes = self._planes(seed=4)
        a = codec.decode_jpeg(codec.encode_jpeg(planes, 90,
                                                arithmetic=True))
        hj = codec.decode_jpeg(codec.encode_jpeg(planes, 90))
        for pa, ph in zip(a.planes, hj.planes):
            assert np.array_equal(pa, ph)

    def test_jpegr_decodes_arith_base(self):
        """API-4 mux with an arithmetic-coded base JPEG must decode
        through the full JPEG/R path (the reference inherits this from
        libjpeg's transparent SOF9 support)."""
        from libultrahdr_dev.jpeg import codec
        from libultrahdr_dev.jpegr import JpegR
        from libultrahdr_dev.types import GainMapMetadata
        planes = self._planes(seed=6)
        base = codec.encode_jpeg(planes, 92, arithmetic=True)
        gmap = codec.encode_jpeg(
            {"y": _synth_gray(16, 12, seed=8)}, 85)
        md = GainMapMetadata(max_content_boost=4.0,
                             min_content_boost=1.0,
                             hdr_capacity_max=4.0)
        jr = JpegR()
        blob = jr.encode_api4(base, gmap, md)
        out = jr.decode(bytes(blob))
        assert (out.width, out.height) == (64, 48)
        assert out.image is not None

    @needs_oracle
    def test_oracle_decodes_codec_arith_output(self, tmp_path):
        from libultrahdr_dev.jpeg import codec
        blob = codec.encode_jpeg(self._planes(seed=5), 88,
                                 restart_interval=3, arithmetic=True)
        jp = str(tmp_path / "e.jpg")
        open(jp, "wb").write(blob)
        cf = str(tmp_path / "e.coef")
        subprocess.run([ORACLE, "coef", jp, cf], check=True)
        want = _read_coefs(cf)
        got = codec.decode_jpeg_coefs(blob)
        for ci in range(3):
            bh, bw = want[ci].shape[:2]
            assert np.array_equal(got.comps[ci][0][:bh, :bw], want[ci])

    @needs_oracle
    @pytest.mark.parametrize("prog,rst", [(0, 0), (0, 5), (1, 0),
                                          (1, 3)])
    def test_decode_jpeg_coefs_color_conformance(self, prog, rst,
                                                 tmp_path):
        from libultrahdr_dev.jpeg import codec
        w, h = 80, 64
        g = _synth_gray(w, h, seed=2)
        rgb = np.stack([g, np.roll(g, 5, 1), np.roll(g, 9, 0)], -1)
        rgb.tofile("/tmp/arith_c.raw")
        jp = str(tmp_path / "c.jpg")
        subprocess.run([ORACLE, "enc", "/tmp/arith_c.raw", str(w),
                        str(h), "3", "90", str(prog), str(rst), jp],
                       check=True)
        cf = str(tmp_path / "c.coef")
        subprocess.run([ORACLE, "coef", jp, cf], check=True)
        want = _read_coefs(cf)
        res = codec.decode_jpeg_coefs(open(jp, "rb").read())
        for ci in range(3):
            bh, bw = want[ci].shape[:2]
            assert np.array_equal(res.comps[ci][0][:bh, :bw],
                                  want[ci]), (prog, rst, ci)


class TestArithFuzz:
    def test_mutated_streams_never_crash(self):
        from libultrahdr_dev.jpeg import codec
        from libultrahdr_dev.types import UhdrError
        rng = np.random.default_rng(17)
        y = _synth_gray(48, 32, seed=13)
        blob = bytearray(codec.encode_jpeg({"y": y}, 80,
                                           arithmetic=True))
        for _ in range(120):
            mut = bytearray(blob)
            for _ in range(rng.integers(1, 6)):
                mut[rng.integers(2, len(mut))] = rng.integers(0, 256)
            try:
                codec.decode_jpeg_coefs(bytes(mut))
            except UhdrError:
                pass

    def test_truncations_never_crash(self):
        from libultrahdr_dev.jpeg import codec
        from libultrahdr_dev.types import UhdrError
        y = _synth_gray(48, 32, seed=14)
        blob = codec.encode_jpeg({"y": y}, 80, restart_interval=2,
                                 arithmetic=True)
        for cut in range(2, len(blob), 37):
            try:
                codec.decode_jpeg_coefs(blob[:cut])
            except UhdrError:
                pass

    def test_bad_dac_rejected(self):
        from libultrahdr_dev.jpeg import codec
        from libultrahdr_dev.types import UhdrError
        y = _synth_gray(32, 32, seed=15)
        blob = bytearray(codec.encode_jpeg({"y": y}, 80,
                                           arithmetic=True))
        i = bytes(blob).find(b"\xff\xcc")
        assert i > 0
        for payload in (b"\x50\x10", b"\x00\x01", b"\x10\x00",
                        b"\x10\x40"):
            mut = bytearray(blob)
            mut[i + 4: i + 6] = payload[:2]
            with pytest.raises(UhdrError):
                codec.decode_jpeg_coefs(bytes(mut))


class TestNativePythonParity:
    """The native port (native/arith.cpp) and the pure-Python
    specification must agree bit-identically: same encoded streams,
    same decoded coefficients, same acceptance of corrupt input."""

    @pytest.fixture(autouse=True)
    def _require_native(self):
        if arith._native() is None:
            pytest.skip("native arith codec unavailable")

    def _python_only(self, monkeypatch):
        monkeypatch.setattr(arith, "_native", lambda: None)

    @pytest.mark.parametrize("restart", [0, 2])
    def test_seq_encode_bitexact(self, restart, monkeypatch):
        blocks = _rand_blocks(24, seed=21)
        comp_ids = np.tile(np.array([0, 0, 1, 2], np.uint8), 6)
        args = (blocks, comp_ids, [0, 1, 1], [0, 1, 1],
                {0: (0, 1), 1: (1, 2)}, {0: 5, 1: 10}, restart, 4)
        native_bits = arith.encode_seq_scan(*args)
        self._python_only(monkeypatch)
        python_bits = arith.encode_seq_scan(*args)
        assert native_bits == python_bits

    @pytest.mark.parametrize("restart", [0, 2])
    def test_seq_decode_bitexact(self, restart, monkeypatch):
        blocks = _rand_blocks(24, seed=22)
        comp_ids = np.tile(np.array([0, 0, 1, 2], np.uint8), 6)
        dc_cond = {0: (0, 1), 1: (2, 3)}
        ac_cond = {0: 5, 1: 63}
        bits = arith.encode_seq_scan(blocks, comp_ids, [0, 1, 1],
                                     [0, 1, 1], dc_cond, ac_cond,
                                     restart, 4)
        out_n = np.zeros_like(blocks)
        arith.decode_seq_scan(bits, out_n, comp_ids, [0, 1, 1],
                              [0, 1, 1], dc_cond, ac_cond, restart, 4)
        self._python_only(monkeypatch)
        out_p = np.zeros_like(blocks)
        arith.decode_seq_scan(bits, out_p, comp_ids, [0, 1, 1],
                              [0, 1, 1], dc_cond, ac_cond, restart, 4)
        np.testing.assert_array_equal(out_n, blocks)
        np.testing.assert_array_equal(out_n, out_p)

    def test_progressive_decode_bitexact(self, monkeypatch):
        # Build a progressive arithmetic stream with libjpeg-free
        # tools: encode DC-first/AC-first/refine scans with the Python
        # encoder primitives, then decode through both driver paths.
        from libultrahdr_dev.jpeg import codec
        y = _synth_gray(48, 40, seed=23)
        blob = codec.encode_jpeg({"y": y}, 80, arithmetic=True)
        ref = codec.decode_jpeg_coefs(blob).comps[0][0]
        self._python_only(monkeypatch)
        ref_py = codec.decode_jpeg_coefs(blob).comps[0][0]
        np.testing.assert_array_equal(np.asarray(ref),
                                      np.asarray(ref_py))

    def test_corrupt_stream_same_verdict(self, monkeypatch):
        blocks = _rand_blocks(16, seed=24)
        comp_ids = np.zeros(16, np.uint8)
        bits = arith.encode_seq_scan(blocks, comp_ids, [0], [0],
                                     {0: arith.DEFAULT_DC_COND},
                                     {0: arith.DEFAULT_AC_COND}, 0, 1)
        rng = np.random.default_rng(25)
        for trial in range(40):
            mut = bytearray(bits)
            for _ in range(rng.integers(1, 5)):
                mut[rng.integers(0, len(mut))] = rng.integers(0, 256)
            mut = bytes(mut)

            def run():
                out = np.zeros_like(blocks)
                try:
                    arith.decode_seq_scan(
                        mut, out, comp_ids, [0], [0],
                        {0: arith.DEFAULT_DC_COND},
                        {0: arith.DEFAULT_AC_COND}, 0, 1)
                    return ("ok", out.tobytes())
                except arith.ArithError:
                    return ("err", None)

            native_res = run()
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(arith, "_native", lambda: None)
                python_res = run()
            assert native_res == python_res, f"trial {trial}"
