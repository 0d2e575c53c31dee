#!/usr/bin/env python
"""Run the test suite one pytest PROCESS per test file.

Why: a single 45-minute in-process run of the full suite can be wiped
out by one XLA-CPU compiler segfault (observed once in round 4 inside
backend_compile_and_load after ~40 min of accumulated compilations —
see ROADMAP.md "known flake"). Process isolation bounds the blast
radius to one file, keeps the persistent compilation cache warm across
processes, and lets CI report which file crashed rather than "the run
died".

Usage: python tools/run_tests_sharded.py [extra pytest args]
Exits nonzero if any shard fails; prints a per-file summary.
"""
import glob
import os
import subprocess
import sys
import time


def main():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = sorted(glob.glob(os.path.join(root, "tests", "test_*.py")))
    extra = sys.argv[1:]
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    # One cache directory for every shard (tests/conftest.py points JAX
    # at it; the env var wins when the caller set it).
    sys.path.insert(0, root)
    from libultrahdr_dev.utils import jaxcache

    env.setdefault(jaxcache.ENV_VAR, jaxcache.DEFAULT_DIR)
    failures = []
    t_all = time.time()
    for f in files:
        rel = os.path.relpath(f, root)
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "pytest", rel, "-q"] + extra,
            cwd=root, env=env)
        dt = time.time() - t0
        status = "ok" if r.returncode == 0 else f"FAIL rc={r.returncode}"
        print(f"[shard] {rel}: {status} ({dt:.0f}s)", flush=True)
        if r.returncode not in (0, 5):   # 5 = no tests collected
            failures.append((rel, r.returncode))
    print(f"[shard] total {time.time() - t_all:.0f}s, "
          f"{len(files)} files, {len(failures)} failed")
    for rel, rc in failures:
        print(f"[shard] failed: {rel} (rc={rc})")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
