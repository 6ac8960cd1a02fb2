#!/usr/bin/env python3
"""Where the serving kernels' time goes, on one CUDA card.

    python3 scripts/serve_kernel_sweep.py

At the headline posterior's shapes (chip_smoke.py's ``serve_inputs``: 800
draws, nc 2, nf 8, 1000 species), prints the device time per call (CUDA
events over a batch, the wrapper's launches together) of:

- B9a (expected moments) at B 1 and 64 for several block targets of the
  draw-chunk split (``ops.serve._PREDICT_TARGET_BLOCKS``);
- B9b (expected, B 64) at mcmc_step 0, 1 and 3 with 0, 500 and 1000 of
  the 1000 species observed, and at 500 observed for 1, 2 and 4 waves of
  draw chunks (``ops.serve._COND_WAVES``).

Each line carries the card's name and power limit.  Needs the repository
and a card; exits non-zero without one.
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("serve_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hmsc_tpu_torch import kernels as K
    from hmsc_tpu_torch.ops import serve as tserve

    torch.backends.cuda.matmul.allow_tf32 = False
    K.library()
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)

    def ms(fn, batch=10):
        return cs.event_ms(torch, fn, batch=batch, trials=5)

    default_p = tserve._PREDICT_TARGET_BLOCKS
    for B in (1, 64):
        args = cs.serve_inputs(torch, dev, B, seed=40 + B)
        for target in (132, 264, 528, 1056):
            tserve._PREDICT_TARGET_BLOCKS = target
            g = tserve.predict_geometry(cs.SERVE["n"], B, cs.SERVE["ns"],
                                        cs.SERVE["nc"], cs.SERVE["nf"])
            t = ms(lambda: tserve.serve_predict(*args, expected=True))
            print(f"B9a B {B}, block target {target} ({g.S} chunks of {g.D} "
                  f"draws, {g.rb} rows a warp, {g.wd} draw slots): "
                  f"{t:.4f} ms [{card}]")
    tserve._PREDICT_TARGET_BLOCKS = default_p

    args = cs.serve_inputs(torch, dev, 64, seed=70)
    X, uidx, rest = args[0], args[1], args[2:]
    for observed in (0, 500, 1000):
        Yc, mask = cs.conditional_query(torch, dev, args, seed=71,
                                        observed=observed)
        for steps in (0, 1, 3):
            t = ms(lambda: tserve.serve_conditional(
                X, uidx, Yc, mask, *rest, mcmc_step=steps, expected=True,
                seed=3), batch=3)
            print(f"B9b B 64, {observed} of {cs.SERVE['ns']} observed, "
                  f"mcmc_step {steps}: {t:.4f} ms [{card}]")
    default_c = tserve._COND_WAVES
    Yc, mask = cs.conditional_query(torch, dev, args, seed=71)
    for waves in (1, 2, 4):
        tserve._COND_WAVES = waves
        g = tserve.conditional_geometry(cs.SERVE["n"], 64, cs.SERVE["ns"],
                                        cs.SERVE["nc"], [cs.SERVE["nf"]])
        t = ms(lambda: tserve.serve_conditional(
            X, uidx, Yc, mask, *rest, mcmc_step=3, expected=True, seed=3),
            batch=3)
        print(f"B9b B 64, mcmc_step 3, {waves} waves of blocks ({g.S} chunks "
              f"of {g.D} draws): {t:.4f} ms [{card}]")
    tserve._COND_WAVES = default_c
    return 0


if __name__ == "__main__":
    sys.exit(main())
