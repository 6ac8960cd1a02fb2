#!/usr/bin/env python3
"""Where the fused CG draw's time goes (kernel B8a's ``vecchia_cg``,
``hmsc_tpu_torch/csrc/vecchia_apply.cu``), on one CUDA card.

    python3 scripts/vecchia_cg_sweep.py [--rounds N]

At chip_smoke.py's B8a shapes (4 chains, nf 2; np 1000 with 10
neighbours, config 3b's, and np 5000 with 8) and on its sampler-like
system (``chip_smoke.b8a_cg_systems``), times one draw (torch.profiler,
the kernel alone) for several cluster sizes (``ops.spatial._CG_UNITS_A_CTA``:
units a CTA, hence CTAs a chain's cluster) and with the vectors in shared
or in global memory: the draw to convergence, and draws of exactly 2 and
10 iterations (tol 0), whose difference over 8 is the cost of one more
iteration.  ``--rounds N`` repeats the list N times in turn.  With
``--variants`` it then builds copies of the source with one part cut
(``VARIANTS``: the applies, or the reductions' cluster step) into
``build/conditional_variants/`` and times their iterations at np 1000
with clusters of 4 and 8 CTAs (their results are wrong; only the time
is read).  Each line carries the card's name and power limit.  It
measures; it changes nothing in the package.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


# diagnostic copies of csrc/vecchia_apply.cu: name -> (what, [(regex,
# replacement)])
VARIANTS = {
    "no_apply": ("the forward and the transpose return zeros", [
        (r"(auto forward = \[&\]\(const float\* v, int i, float "
         r"\(&out\)\[NFM\]\) \{)", r"\1\n    for (int f = 0; f < NFM; "
         r"++f) out[f] = 0.0f;\n    if (nf > 0) return;"),
        (r"(auto adjoint = \[&\]\(const float\* tv, const float\* v, bool "
         r"lik, int jn,\s*float \(&out\)\[NFM\]\) \{)",
         r"\1\n    for (int f = 0; f < NFM; ++f) out[f] = 0.0f;\n    if "
         r"(nf > 0) return;")]),
    "cta_reduce": ("the dot products summed in the CTA only", [
        (r"    sync\(\);\n    float o0 = 0\.0f, o1 = 0\.0f;\n    for "
         r"\(int q = 0; q < G; \+\+q\)",
         "    __syncthreads();\n    float o0 = 0.0f, o1 = 0.0f;\n    for "
         "(int q = 0; q < 1; ++q)")]),
}


def variant_ms(torch, cs, tsp, K, lvd, system, units):
    """Per-iteration device time of each diagnostic copy (tol 0: 10
    iterations against 2) at clusters of ``units`` units a CTA."""
    import ctypes

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from serve_conditional_sweep import build

    src = (K._CSRC / "vecchia_apply.cu").read_text()
    # the loop runs maxiter times whatever the (now wrong) numbers give
    fixed = [(r"while \(gamma > atol2 && it < a\.maxiter\)",
              "while (it < a.maxiter)")]
    libs = build(src, {k: v[1] + fixed for k, v in VARIANTS.items()}, "cg")
    main_lib = K.library()
    alpha, LiSL, F, eps1, b_like, x0 = system
    out = {}
    saved = tsp._CG_UNITS_A_CTA
    try:
        for name, (lib, _) in libs.items():
            lib.hmsc_vecchia_cg.argtypes = main_lib.hmsc_vecchia_cg.argtypes
            lib.hmsc_vecchia_cg.restype = ctypes.c_int
            K._lib = lib
            tsp._CG_UNITS_A_CTA = units

            def draw(m):
                return lambda: tsp.vecchia_cg(lvd, alpha, LiSL, F, eps1,
                                              b_like, x0, 0.0, m)

            ms2 = cs.device_ms(torch, draw(2), "vecchia_cg_kernel")
            ms10 = cs.device_ms(torch, draw(10), "vecchia_cg_kernel")
            out[name] = (ms10 - ms2) / 8
    finally:
        K._lib = main_lib
        tsp._CG_UNITS_A_CTA = saved
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--variants", action="store_true")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("vecchia_cg_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hmsc_tpu_torch import kernels as K
    from hmsc_tpu_torch.mcmc import spatial as tms
    from hmsc_tpu_torch.ops import spatial as tsp

    K.library()
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    levels = {}
    for n, k, side in cs.B8_SHAPES:
        lvd = cs.nngp_level(torch, dev, n, k, side, seed=n)
        levels[n] = (lvd, k, cs.b8a_cg_systems(torch, dev, n,
                                               seed=n + 7)["sampler"])
    saved = (tsp._CG_UNITS_A_CTA, tsp._CG_SMEM_MAX)
    try:
        for rnd in range(opts.rounds):
            for n, (lvd, k, (alpha, LiSL, F, eps1, b_like, x0)) in \
                    levels.items():
                for units, smem_max in ((1024, saved[1]), (512, saved[1]),
                                        (256, saved[1]), (128, saved[1]),
                                        (256, 0)):
                    tsp._CG_UNITS_A_CTA, tsp._CG_SMEM_MAX = units, smem_max
                    G, per, threads, smem, glob = tsp.cg_geometry(
                        n, cs.B8_NF)

                    def draw(tol=tms.CG_TOL, m=tms.CG_MAXITER):
                        return lambda: tsp.vecchia_cg(
                            lvd, alpha, LiSL, F, eps1, b_like, x0, tol, m)

                    iters = draw()()[2].tolist()
                    ms = cs.device_ms(torch, draw(), "vecchia_cg_kernel")
                    ms2 = cs.device_ms(torch, draw(0.0, 2),
                                       "vecchia_cg_kernel")
                    ms10 = cs.device_ms(torch, draw(0.0, 10),
                                        "vecchia_cg_kernel")
                    where = "global" if glob else "shared"
                    print(f"round {rnd}: np {n}, k {k}: clusters of {G} CTAs "
                          f"of {threads} threads ({per} units a CTA, vectors "
                          f"in {where} memory): draw "
                          f"{ms:.5f} ms (iterations {iters}); 2 iterations "
                          f"{ms2:.5f} ms, 10 iterations {ms10:.5f} ms, "
                          f"{(ms10 - ms2) / 8:.5f} ms an iteration [{card}]",
                          flush=True)
    finally:
        tsp._CG_UNITS_A_CTA, tsp._CG_SMEM_MAX = saved
    if opts.variants:
        lvd, k, system = levels[1000]
        for units in (256, 128):
            got = variant_ms(torch, cs, tsp, K, lvd, system, units)
            print(f"np 1000, {units} units a CTA, ms an iteration: "
                  + "; ".join(
                      f"{name} ({VARIANTS[name][0]}) {v:.5f}"
                      for name, v in got.items()) + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
