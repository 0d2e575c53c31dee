"""chip_smoke.py and the bring-up plumbing around it.

CPU tests cover the smoke's comparison helpers, its refusal to run
without a GPU, the compile-cache helper, the live-backend probe and
the multi-device dry run's device check, plus the smoke's check
functions at small shapes on the CPU backend. The `gpu`-marked tests
run the same check functions at full size and skip without a GPU
(run them on the card with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_chip_smoke.py`).
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from libultrahdr_dev.utils import jaxcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------
# Comparison helpers
# ---------------------------------------------------------------------

class TestHelpers:
    def test_psnr_identical_and_known(self):
        a = np.zeros((4, 4))
        assert cs.psnr(a, a, 1.0) == 99.0
        b = a + 0.1  # mse 0.01 -> 20 dB at peak 1
        assert cs.psnr(b, a, 1.0) == pytest.approx(20.0)

    def test_delta_stats_counts_and_share(self):
        a = np.array([0, 1, 2, 3], np.int16)
        b = np.array([0, 2, 2, 1], np.int16)
        assert cs.delta_stats(a, b) == (2, 2, 0.5)
        assert cs.delta_stats(a, a) == (0, 0, 0.0)

    def test_channels_1010102_unpacks_rgb(self):
        px = np.array([(3 << 30) | (7 << 20) | (5 << 10) | 1], np.uint32)
        np.testing.assert_array_equal(cs.channels_1010102(px),
                                      [[1, 5, 7]])

    def test_channel_psnr_1010102(self):
        px = np.array([[1 | (2 << 10) | (3 << 20)]], np.uint32)
        assert cs.channel_psnr_1010102(px, px) == [99.0] * 3
        other = np.array([[2 | (2 << 10) | (3 << 20)]], np.uint32)
        r, g, b = cs.channel_psnr_1010102(px, other)
        assert r == pytest.approx(20 * np.log10(1023.0)) and g == b == 99.0

    @pytest.mark.parametrize("layout", ["u64", "halves"])
    def test_f16_bits_layouts(self, layout):
        halves = np.arange(2 * 3 * 4, dtype=np.uint16).reshape(2, 3, 4)
        arr = halves.view(np.uint64)[..., 0] if layout == "u64" else halves
        np.testing.assert_array_equal(cs.f16_bits(arr), halves)

    def test_f16_ulp_diff(self):
        one = np.array([[1.0, 1.0, 1.0, 1.0]], np.float16)
        nxt = np.nextafter(one, np.float16(2))
        assert cs.f16_ulp_diff(one, one) == 0
        assert cs.f16_ulp_diff(one, nxt) == 1
        pz = np.zeros((1, 4), np.float16)
        nz = -pz
        assert cs.f16_ulp_diff(pz, nz) == 0  # +0 and -0 coincide
        tiny = np.full((1, 4), np.finfo(np.float16).smallest_subnormal,
                       np.float16)
        assert cs.f16_ulp_diff(tiny, -tiny) == 2  # across zero

    def test_checks_record_and_raise(self, capsys):
        c = cs.Checks("t")
        assert c.le("a", 1, 1) and c.ge("b", 2, 1) and c.eq("c", "x", "x")
        c.done()
        assert not c.le("d", 2, 1)
        out = capsys.readouterr().out
        assert "[t] a: 1 (<= 1) ok" in out and "[t] d: 2 (<= 1) FAIL" in out
        with pytest.raises(cs.CheckFailed, match="1 check"):
            c.done()

    def test_last_line_format(self):
        class Dev:
            platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

        line = cs.last_line([Dev()])
        assert json.loads(line) == {"ok": True, "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
            "count": 1}}
        assert "\n" not in line


class TestUnpinnedDots:
    X = jnp.ones((8, 8), jnp.float32)

    def test_default_precision_f32_dot_is_flagged(self):
        bad = cs.unpinned_f32_dots(jax.make_jaxpr(jnp.dot)(self.X, self.X))
        assert len(bad) == 1 and "dot_general" in bad[0]

    def test_highest_precision_passes(self):
        f = lambda a, b: jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)
        assert cs.unpinned_f32_dots(jax.make_jaxpr(f)(self.X, self.X)) == []

    def test_bf16_operands_pass(self):
        b = self.X.astype(jnp.bfloat16)
        f = lambda a, c: jnp.dot(a, c, preferred_element_type=jnp.float32)
        assert cs.unpinned_f32_dots(jax.make_jaxpr(f)(b, b)) == []

    def test_nested_jit_and_cond_are_walked(self):
        inner = jax.jit(lambda a: jnp.dot(a, a))

        def f(a, p):
            return jax.lax.cond(p, inner, lambda a: a, a)

        bad = cs.unpinned_f32_dots(jax.make_jaxpr(f)(self.X, True))
        assert len(bad) == 1

    def test_production_dct_kernels_are_pinned(self):
        from libultrahdr_dev.jpeg import dct

        plane = jnp.zeros((16, 16), jnp.uint8)
        q = jnp.ones(64, jnp.float32)
        assert cs.unpinned_f32_dots(
            jax.make_jaxpr(dct.fdct_zigzag)(plane, q)) == []
        idct = dct._idct_kernel(16, 16)
        assert cs.unpinned_f32_dots(jax.make_jaxpr(idct)(
            jnp.zeros((4, 64), jnp.int16), jnp.ones(64, jnp.int32))) == []


# ---------------------------------------------------------------------
# No accelerator: the smoke refuses to run
# ---------------------------------------------------------------------

class TestNoAccelerator:
    def test_smoke_exits_nonzero_on_cpu_backend(self, capsys):
        with pytest.raises(SystemExit) as e:
            cs.main([])
        assert e.value.code not in (0, None)
        assert '"ok": true' not in capsys.readouterr().out

    def test_smoke_alone_fails_without_the_package(self, tmp_path):
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        r = subprocess.run([sys.executable, "chip_smoke.py"],
                           cwd=tmp_path, env=env, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


# ---------------------------------------------------------------------
# Compile cache, backend probe, multi-device dry run
# ---------------------------------------------------------------------

class TestJaxCache:
    def test_env_var_is_honoured_and_nothing_set(self, monkeypatch):
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        monkeypatch.setenv(jaxcache.ENV_VAR, "/somewhere/else")
        assert jaxcache.configure() == "/somewhere/else"
        assert calls == []

    def test_default_is_fixed_inside_the_checkout(self, monkeypatch):
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        monkeypatch.delenv(jaxcache.ENV_VAR, raising=False)
        path = jaxcache.configure()
        assert path == os.path.join(REPO, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]

    def test_default_dir_is_gitignored(self):
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


class TestAccelBackend:
    def test_reads_live_backend_without_subprocess(self, monkeypatch):
        from libultrahdr_dev.jpeg import codec

        def no_subprocess(*a, **k):
            raise AssertionError("backend probe must not start a process")

        monkeypatch.setattr(subprocess, "run", no_subprocess)
        monkeypatch.setattr(codec, "_DEVICE_CODEC_ON_CPU", False)
        assert codec._accel_backend() is False
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert codec._accel_backend() is True

    def test_test_override_wins(self, monkeypatch):
        from libultrahdr_dev.jpeg import codec

        monkeypatch.setattr(codec, "_DEVICE_CODEC_ON_CPU", True)
        assert codec._accel_backend() is True


class TestDryrunMultichip:
    def test_raises_when_devices_are_missing(self):
        import __graft_entry__

        n = len(jax.devices()) * 2
        with pytest.raises(RuntimeError, match=f"needs {n} devices"):
            __graft_entry__.dryrun_multichip(n)


class TestApplyPlanesHostValidation:
    def _args(self, rows, dtype=np.uint8):
        h, w, gh, gw = 16, 32, 4, 8
        comp = np.zeros((1, rows, w), dtype)
        return comp, np.ones((1, 4), np.float32), h, w, gh, gw

    def test_short_composite_is_rejected(self):
        from libultrahdr_dev.parallel import sharding

        if not sharding.hostapply_available("hdr_hlg"):
            pytest.skip("native apply unavailable")
        with pytest.raises(ValueError, match="too small"):
            sharding.apply_planes_host(*self._args(16 + 8 + 3), "hdr_hlg")

    def test_wrong_dtype_is_rejected(self):
        from libultrahdr_dev.parallel import sharding

        if not sharding.hostapply_available("hdr_hlg"):
            pytest.skip("native apply unavailable")
        with pytest.raises(ValueError, match="uint8"):
            sharding.apply_planes_host(*self._args(28, np.uint16),
                                       "hdr_hlg")


class TestBenchPeaks:
    def test_h100_peaks_and_unknown_kind(self):
        import bench

        assert bench.device_peaks("NVIDIA H100 80GB HBM3") == {
            "hbm_GBps": 3350.0, "bf16_tflops": 989.0}
        with pytest.raises(KeyError, match="no published peaks"):
            bench.device_peaks("cpu")


# ---------------------------------------------------------------------
# The smoke's checks at small shapes on the CPU backend
# ---------------------------------------------------------------------

class TestSmokeChecksOnCpu:
    def test_golden_decode_check(self):
        checks = cs.Checks("goldens")
        cs.check_golden(checks, "2100", "hlg")
        checks.done()

    def test_main_path_checks(self):
        res = cs.run_main_path(2, 256, 384)
        assert res["entropy_decode_trips"] > 0
        assert res["fdct_luma_diff"] == (0, 0.0)
        assert res["gainmap_diff"] == (0, 0.0)

    def test_entropy_encode_check_catches_a_changed_stream(
            self, monkeypatch):
        from libultrahdr_dev.container import mux
        from libultrahdr_dev.jpeg import codec
        from libultrahdr_dev.parallel import sharding
        from libultrahdr_dev.utils.synth import synth_p010_batch

        ys, uvs = synth_p010_batch(1, 64, 96)
        blob = sharding.batched_encode_api0(
            ys, uvs, sharding.default_mesh(jax.devices()[:1]))[0]
        primary, gmap = mux.extract_primary_and_gainmap(blob)
        checks = cs.Checks("t")
        cs.check_entropy_encode(checks, primary, "base")
        cs.check_entropy_encode(checks, gmap, "gain map")
        checks.done()
        real = codec.entropy_encode
        monkeypatch.setattr(codec, "entropy_encode",
                            lambda *a: real(*a)[:-1] + b"\x00")
        cs.check_entropy_encode(checks, primary, "changed")
        with pytest.raises(cs.CheckFailed, match="changed"):
            checks.done()

    def test_entropy_decode_check_reports_trips(self):
        from libultrahdr_dev.container import mux
        from libultrahdr_dev.parallel import sharding
        from libultrahdr_dev.utils.synth import synth_p010_batch

        ys, uvs = synth_p010_batch(1, 64, 96)
        blob = sharding.batched_encode_api0(
            ys, uvs, sharding.default_mesh(jax.devices()[:1]))[0]
        checks = cs.Checks("t")
        for jpeg in mux.extract_primary_and_gainmap(blob):
            trips, ms = cs.check_entropy_decode(checks, jpeg, "x")
            assert trips > 0 and ms >= 0
        checks.done()

    def test_entropy_decode_check_rejects_foreign_stream(self):
        from libultrahdr_dev.jpeg import codec

        jpeg = codec.encode_jpeg({"y": np.zeros((16, 16), np.uint8)},
                                 quality=90, arithmetic=True)
        with pytest.raises(cs.CheckFailed, match="not device-decodable"):
            cs.check_entropy_decode(cs.Checks("t"), jpeg, "arith")

    def test_fdct_and_gainmap_checks_agree_on_one_backend(self):
        from libultrahdr_dev.jpeg import tables
        from libultrahdr_dev.utils.synth import synth_p010

        y, uv = synth_p010(64, 96, seed=3)
        checks = cs.Checks("t")
        assert cs.check_fdct(checks, (y >> 8).astype(np.uint8),
                             tables.STD_LUMINANCE_QUANT, "luma") == (0, 0.0)
        assert cs.check_gainmap(checks, y, uv) == (0, 0.0)
        checks.done()

    def test_pixel_check_bounds(self):
        a = np.array([[1 | (2 << 10) | (3 << 20)]], np.uint32)
        b = np.array([[3 | (2 << 10) | (3 << 20)]], np.uint32)
        checks = cs.Checks("t")
        cs.check_pixels(checks, a, a, "hdr_hlg", "same")
        checks.done()
        cs.check_pixels(checks, a, b, "hdr_hlg", "two codes")
        with pytest.raises(cs.CheckFailed, match="two codes"):
            checks.done()


# ---------------------------------------------------------------------
# The same checks on the card
# ---------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("gn,tn", cs.GOLDEN_CONFIGS)
def test_golden_decode_on_gpu(gpu_backend, gn, tn):
    checks = cs.Checks("goldens")
    cs.check_golden(checks, gn, tn)
    checks.done()


@pytest.mark.gpu
def test_main_path_on_gpu(gpu_backend):
    cs.run_main_path()
