#!/usr/bin/env python3
"""Where kernel B4's time goes (``hmsc_tpu_torch/csrc/gamma_v.cu``, the
GammaV block in one launch), on one CUDA card.

    python3 scripts/gamma_v_sweep.py [--source a,b] [--older FILE]
                                     [--rounds N]

At ``chip_smoke.B4_SHAPES`` (4 chains; nc, nt, ns = 2, 1, 1000 (the
headline), 8, 4, 1000 and 16, 4, 5000) it prints, in turns for ``--rounds
N`` rounds, the kernel's device time with its draws from Philox, as the
sampler calls it (torch.profiler, the kernel alone), the block as the
sampler ran it before (``ops.rand.gamma_v_plain``: torch ops and B3's
element form, all its device work a call), and the host time a call of
each (perf_counter over 200 calls queued without synchronisation: what
the sampler's host pays to enqueue the block).  ``--source a,b`` builds
copies of the kernel's source with a part changed or cut
(``SRC_VARIANTS``) and times them at the same shapes; ``--older FILE``
builds an older source with the same C interface (a path inside the
repository, for example under ``build/``) and times it in the same turns.  Each
line carries the card's name and power limit.  It measures; it changes
nothing in the package.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

# copies of the source: name -> (what, [(regex, replacement)]); each
# computes something else, only its time is read
SRC_VARIANTS = {
    "empty": ("the launch alone (every thread returns at once)", [
        (r"(  extern __shared__ float sm\[\];\n)",
         r"\1  if (a.ns > 0) return;\n")]),
    "sums_only": ("the species pass alone (return after the sums)", [
        (r"(  __syncthreads\(\);\n\n  if \(warp == 0\) \{)",
         "  __syncthreads();\n  if (ns > 0) return;\n\n  if (warp == 0) {")]),
    "no_draws": ("the Bartlett factor's draws cut (the gamma shape and "
                 "0.5 for the normals)", [
        (r"hmsc::standard_gamma_draw\(shape, i, a\.key,\s*a\.off_gamma\)",
         "shape"),
        (r"philox_normal\(i, a\.key, a\.off_normal\)", "0.5f")]),
    "no_gamma": ("Gamma | Beta, iV cut (return once iV is written)", [
        (r"(  // Gamma \| Beta, iV: the \(n, n\) precision)",
         r"  if (ns > 0) return;\n\1")]),
    "no_const": ("the constants' copies cut (their values unset)", [
        (r"  for \(int t = tid; t < nc \* nc; t \+= kThreads\) "
         r"cp_async4\(V0s \+ t, a\.V0 \+ t\);\n", ""),
        (r"  for \(int t = tid; t < nt \* nt; t \+= kThreads\) "
         r"cp_async4\(TtTs \+ t, a\.TtT \+ t\);\n", ""),
        (r"  for \(int t = tid; t < n \* n; t \+= kThreads\) "
         r"cp_async4\(iUGs \+ t, a\.iUG \+ t\);\n", ""),
        (r"  for \(int t = tid; t < n; t \+= kThreads\) "
         r"cp_async4\(iUGmGs \+ t, a\.iUGmG \+ t\);\n", "")]),
    "no_eps": ("eps's draw cut (0)", [
        (r"es\[t\] = a\.eps \? __ldg\(a\.eps \+ i\) : philox_normal\(i, "
         r"a\.key, a\.off_eps\);", "es[t] = 0.0f;")]),
}


def host_us(torch, fn, calls=200):
    """Host microseconds a call, ``calls`` calls queued, one sync after."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default="")
    ap.add_argument("--older", default="")
    ap.add_argument("--rounds", type=int, default=1)
    opts = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("gamma_v_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hmsc_tpu_torch import kernels as K
    from hmsc_tpu_torch.ops import rand as trand
    from probit_z_sweep import build_variants, use_library

    card = cs.card_line()
    print(card)
    dev = torch.device("cuda", 0)
    K.library()
    rng = trand.Rng(7, dev)
    C = cs.HEADLINE["n_chains"]
    cases = []
    for nc, nt, ns in cs.B4_SHAPES:
        args, df, noise = cs.b4_inputs(torch, trand, dev, C, nc, nt, ns,
                                       seed=nc * nt)
        cases.append(((nc, nt, ns), args, df, noise,
                      lambda args=args, df=df: trand.gamma_v(
                          **args, df=df, rng=rng),
                      lambda args=args, df=df: trand.gamma_v_plain(
                          **args, df=df, rng=rng)))
    libs = {}
    src_names = [v for v in opts.source.split(",") if v]
    if src_names:
        src = (K._CSRC / "gamma_v.cu").read_text()
        libs = {v: lib for v, (lib, _) in build_variants(
            src, {v: SRC_VARIANTS[v][1] for v in src_names}, "gamma_v",
            "gamma_v").items()}
    if opts.older:
        older = pathlib.Path(opts.older).read_text()
        lib = build_variants(older, {"older": []}, "gamma_v",
                             "gamma_v")["older"][0]
        restore = use_library(K, lib, ("hmsc_gamma_v",))
        try:                             # the older source computes B4 too
            for shape, args, df, noise, _, _ in cases:
                iVk, Gk = trand.gamma_v(**args, df=df, noise=noise)
                iVp, Gp = trand.gamma_v_plain(**args, df=df, noise=noise)
                rel = max(cs._rel(iVk, iVp), cs._rel(Gk, Gp))
                assert rel <= 1e-4, f"older source at {shape}: rel {rel}"
        finally:
            restore()
        libs["older"] = lib
    for rnd in range(opts.rounds):
        for shape, args, df, noise, kern, before in cases:
            ms = cs.device_ms(torch, kern, "gamma_v_kernel")
            old = cs.device_ms(torch, before, calls=20)
            hk, hb = host_us(torch, kern), host_us(torch, before, 50)
            line = [f"shipped {ms:.5f} ms"]
            for v, lib in libs.items():
                restore = use_library(K, lib, ("hmsc_gamma_v",))
                try:
                    line.append(f"{v} " + format(cs.device_ms(
                        torch, kern, "gamma_v_kernel"), ".5f") + " ms")
                finally:
                    restore()
            print(f"round {rnd}: C {C}, nc {shape[0]}, nt {shape[1]}, ns "
                  f"{shape[2]}: " + ", ".join(line) + f"; the block before "
                  f"{old:.5f} ms of device work; host a call: kernel "
                  f"{hk:.1f} us, the block before {hb:.1f} us [{card}]",
                  flush=True)
    for v in libs:
        print(f"source {v}: " + (SRC_VARIANTS[v][0] if v in SRC_VARIANTS
                                 else opts.older))
    return 0


if __name__ == "__main__":
    sys.exit(main())
