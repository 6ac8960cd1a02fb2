#!/usr/bin/env python3
"""Where the LambdaPriors block's time goes on one CUDA card: kernel B3's
shrinkage form (``hmsc_tpu_torch/csrc/shrinkage_gamma.cu``, a level's
whole update in one launch) against the block as the sampler ran it
before it (B3's element form for psi, then a delta draw and the update's
tensor ops a factor, ``shrinkage_update`` on ``standard_gamma``).

    python3 scripts/shrinkage_sweep.py [--variants a,b] [--source a,b]
        [--rounds N]

At ``chip_smoke.py``'s shrinkage shapes (4 chains; nf, ns = 8, 1000 (the
headline), 2, 90 (config 5), 2, 50 (config 3), 20, 5000) it prints, in
turns for ``--rounds N`` rounds: the shrinkage kernel's device time
(torch.profiler, the kernel alone) under each launch shape of
``--variants`` (``VARIANTS``: ``ops.rand.shrinkage_launch``, the shape
the card's cluster query allows, with fields overridden), the older block's device time (all its kernels a call), and
the host time a call of each (perf_counter over 200 calls queued without
synchronisation: what the sampler's host pays to enqueue the block).
``--source a,b`` builds copies of the kernel's source with a part cut
(``SRC_VARIANTS``) and times them at the shipped shapes.  The shipped
kernel is first held against the plain update fed with the element
form's draws at the same Philox counters (1e-5 relative).  Each line
carries the card's name and power limit.  It measures; it changes nothing
in the package.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

# launch shapes: name -> (what, override(geometry) or None)
VARIANTS = {
    "shipped": ("the launch as shipped", None),
    "S8": ("clusters of 8 blocks, not 16 (two psi a lane, on half the "
           "SMs)", lambda g: dict(g, S=8) if g["S"] == 16 else g),
}

# copies of the source, each with a part cut: name -> (what, [(regex,
# replacement)]); their results are wrong, only the time is read
SRC_VARIANTS = {
    "empty": ("the launch alone (every block returns at once)", [
        (r"(  extern __shared__ float sm\[\];)",
         r"\1\n  if (a.nf > 0) return;")]),
    "no_psi_draw": ("psi's gamma draws cut (the shape for the draw)", [
        (r"hmsc::standard_gamma_draw\(shape, i, a\.key, a\.off_psi\)",
         "shape")]),
    "no_delta_draw": ("delta's gamma draws cut", [
        (r"gd\[t\] = hmsc::standard_gamma_draw\(\s*ad, [^;]*;",
         "gd[t] = ad;")]),
    "no_chain": ("the chain over the factors cut (block 0 returns after "
                 "the sums)", [
        (r"(\n  // the chain over the factors, a thread a column)",
         r"\n  if (nf > 0) return;\1")]),
}


def _geometry(trand, override):
    """Point the wrapper's launch shape (``shrinkage_launch``, the shape the
    card's cluster query allows) at ``override`` of it; returns the restore
    callable."""
    base = trand.shrinkage_launch
    if override is not None:
        trand.shrinkage_launch = lambda *a: override(base(*a))
    return lambda: setattr(trand, "shrinkage_launch", base)


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
    ap.add_argument("--variants", default="shipped")
    ap.add_argument("--source", default="")
    ap.add_argument("--rounds", type=int, default=1)
    opts = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("shrinkage_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hmsc_tpu_torch import kernels as K
    from hmsc_tpu_torch.ops import rand as trand

    card = cs.card_line()
    print(card)
    dev = torch.device("cuda", 0)
    K.library()
    C = cs.HEADLINE["n_chains"]
    rng = trand.Rng(7, dev)
    cases = []
    for nf, ns in cs.B3S_SHAPES:
        Lam, mask, Delta, prior = cs.shrinkage_inputs(torch, dev, C, nf, ns,
                                                      seed=nf + ns)
        a_psi, ad = trand.shrinkage_shapes(mask, *prior[:2], prior[3], ns)
        fix = cs.FixedPhilox(99, 5)
        Pk, Dk = trand.shrinkage_gamma(Lam, mask, Delta, *prior, fix)
        g = trand.standard_gamma(a_psi.expand(Lam.shape).contiguous(), fix)
        gd = trand.standard_gamma(ad.contiguous(), cs.FixedPhilox(
            99, trand.delta_offset(5)))
        Pp, Dp = trand.shrinkage_update(Lam, mask, Delta, prior[0], prior[2],
                                        prior[4], g, lambda h: gd[:, h])
        rel = max(((Pk - Pp).abs() / Pp.abs()).max().item(),
                  ((Dk - Dp).abs() / Dp.abs()).max().item())
        assert rel <= 1e-5, f"nf {nf} ns {ns}: {rel}"

        def before(Lam=Lam, mask=mask, Delta=Delta, prior=prior, ns=ns):
            a_psi, ad = trand.shrinkage_shapes(mask, *prior[:2], prior[3],
                                               ns)
            g = trand.standard_gamma(a_psi.expand(Lam.shape).contiguous(),
                                     rng)
            return trand.shrinkage_update(
                Lam, mask, Delta, prior[0], prior[2], prior[4], g,
                lambda h: trand.standard_gamma(ad[:, h].contiguous(), rng))

        def kern(Lam=Lam, mask=mask, Delta=Delta, prior=prior):
            return trand.shrinkage_gamma(Lam, mask, Delta, *prior, rng)

        cases.append((nf, ns, kern, before))
    names = opts.variants.split(",")
    for rnd in range(opts.rounds):
        for nf, ns, kern, before in cases:
            line = []
            for v in names:
                restore = _geometry(trand, VARIANTS[v][1])
                try:
                    geo = trand.shrinkage_launch(torch.device("cuda", 0),
                                                 nf, ns, 1)
                    ms = cs.device_ms(torch, kern, "shrinkage_gamma_kernel")
                finally:
                    restore()
                line.append(f"{v} (S {geo['S']}, T {geo['T']}, P "
                            f"{geo['P']}) {ms:.5f} ms")
            old = cs.device_ms(torch, before, calls=20)
            hk, hb = host_us(torch, kern), host_us(torch, before, 50)
            print(f"round {rnd}: C {C}, nf {nf}, ns {ns}: "
                  + ", ".join(line) + f"; the block before {old:.5f} ms of "
                  f"device work; host a call: kernel {hk:.1f} us, the block "
                  f"before {hb:.1f} us [{card}]", flush=True)
    src_names = [v for v in opts.source.split(",") if v]
    if src_names:
        from probit_z_sweep import build_variants, use_library

        src = (K._CSRC / "shrinkage_gamma.cu").read_text()
        libs = build_variants(src, {v: SRC_VARIANTS[v][1]
                                    for v in src_names},
                              "shrinkage_gamma", "shrinkage")
        for v in src_names:
            restore = use_library(K, libs[v][0], ("hmsc_shrinkage_gamma",))
            try:
                line = []
                for nf, ns, kern, _ in cases:
                    ms = cs.device_ms(torch, kern, "shrinkage_gamma_kernel")
                    line.append(f"nf {nf} ns {ns}: {ms:.5f} ms")
            finally:
                restore()
            print(f"source {v} ({SRC_VARIANTS[v][0]}): " + "; ".join(line)
                  + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
