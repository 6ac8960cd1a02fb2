#!/usr/bin/env python3
"""Where kernel B2's time goes (``hmsc_tpu_torch/csrc/mvn_prec_small.cu``,
a group of P lanes a system, its three forms), on one CUDA card.

    python3 scripts/mvn_prec_sweep.py [--source a,b] [--older FILE]
                                      [--rounds N]

At ``chip_smoke.py``'s B2 inputs (the headline's shapes: 4 chains x 1000
systems; the element and BetaLambda forms at P 10, the Eta forms at P 8;
``chip_smoke.B2_FORMS``) it prints, in turns for ``--rounds N`` rounds,
the shipped kernel's device time in each form (torch.profiler, the kernel
alone; the forms but the element one with their eps drawn in the kernel,
as the sampler calls them) beside B2's first version on the element form
(``scripts/older/mvn_prec_small.cu``, one system a thread).  ``--source
a,b`` builds copies of the shipped source with a part changed or cut
(``SRC_VARIANTS``) and times them the same way; ``--older FILE`` builds an
older source of the shipped kernel with the same C interface (for example
``git show <rev>:hmsc_tpu_torch/csrc/mvn_prec_small.cu``, written to a
path inside the repository such as ``build/``) and times it in the same
turns, so that an edit is timed against the source before it in one
process.  Each line carries the card's name and power limit.  It
measures; it changes nothing in the package.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

# copies of the source: name -> (what, [(regex, replacement)], computes
# the same function); the cut ones compute something else, only their time
# is read, the others are first held against the plain version (1e-4)
SRC_VARIANTS = {
    "empty": ("the launch alone (every thread returns at once)", [
        (r"(  __shared__ float tile\[SPB \* P \* LD\];\n)",
         r"\1  if (a.batch > 0) return;\n")], False),
    "load_only": ("the loads and the assembly, no factorisation or "
                  "solves", [
        (r"(  // jitter: \(1e-6 / P\))",
         r"  if (a.batch > 0) {\n    if (live) a.out[bb * P + i] = "
         r"row[P - 1] + r + e;\n    return;\n  }\n\1")], False),
    "no_back": ("the back solve cut (y + eps written)", [
        (r"  // back solve L' x = y \+ eps in the JAX op's order",
         "  if (live) a.out[bb * P + i] = y_i + e;\n  if (a.batch > 0) "
         "return;\n  // back solve")], False),
    "threads256": ("blocks of 256 threads, not 128", [
        (r"constexpr int kThreads = 128;", "constexpr int kThreads = 256;")],
        True),
    "ieee_div": ("the pivot's reciprocal as 1 / sqrtf, rounded twice (as "
                 "the JAX op)", [
        (r"const float inv = __frsqrt_rn\(piv\);",
         "const float inv = 1.0f / sqrtf(piv);")], True),
}

FIRST_SOURCE = "scripts/older/mvn_prec_small.cu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default="")
    ap.add_argument("--older", default="")
    ap.add_argument("--rounds", type=int, default=1)
    opts = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("mvn_prec_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hmsc_tpu_torch import kernels as K
    from hmsc_tpu_torch.ops import linalg as tlinalg
    from hmsc_tpu_torch.ops import rand as trand
    from probit_z_sweep import build_variants, use_library

    card = cs.card_line()
    print(card)
    dev = torch.device("cuda", 0)
    K.library()
    first = cs.build_source(FIRST_SOURCE, "mvn_prec_small_first")
    rng = trand.Rng(3, dev)
    calls = {}
    for form in cs.B2_FORMS:
        kw, _ = cs.b2_inputs(torch, dev, form, seed=len(form))
        if form == "element":
            calls[form] = (lambda kw=kw: tlinalg.sample_mvn_prec_batched(
                **kw))
            calls["first"] = (lambda kw=kw: cs.first_b2(
                torch, first, kw["prec"], kw["rhs"], kw["eps"]))
        elif form.startswith("beta"):
            calls[form] = (lambda kw=kw: tlinalg.sample_beta_lambda(
                **dict(kw, eps=None), rng=rng))
        else:
            calls[form] = (lambda kw=kw: tlinalg.sample_mvn_prec_shifted(
                **dict(kw, eps=None), rng=rng))
    src_names = [v for v in opts.source.split(",") if v]
    libs = {}
    if src_names:
        src = (K._CSRC / "mvn_prec_small.cu").read_text()
        libs = {v: lib for v, (lib, _) in build_variants(
            src, {v: SRC_VARIANTS[v][1] for v in src_names},
            "mvn_prec_small", "mvn_prec_small").items()}
    if opts.older:
        older = pathlib.Path(opts.older).read_text()
        libs["older"] = build_variants(older, {"older": []},
                                       "mvn_prec_small",
                                       "mvn_prec_small")["older"][0]

    def times(names):
        return "; ".join(f"{f} " + format(cs.device_ms(
            torch, calls[f], "mvn_prec_small_kernel"), ".5f") for f in names)

    kw, bad = cs.b2_inputs(torch, dev, "beta_lambda", seed=11)
    plain = tlinalg._sample_mvn_prec_small_plain(
        *tlinalg._beta_lambda_system(
            **{k: v for k, v in kw.items() if k != "eps"}), kw["eps"])
    for v, lib in libs.items():
        if v in SRC_VARIANTS and not SRC_VARIANTS[v][2]:
            continue
        restore = use_library(K, lib, ("hmsc_mvn_prec_small",))
        try:
            x = tlinalg.sample_beta_lambda(**kw)
        finally:
            restore()
        ok = ~torch.isnan(plain).flatten(0, 1).all(1)
        rel = cs._rel(x.flatten(0, 1)[ok], plain.flatten(0, 1)[ok])
        assert rel <= 1e-4, f"source {v}: rel {rel}"
        print(f"source {v}: the BetaLambda form within {rel:.3g} of the "
              f"plain version (1e-4)", flush=True)

    forms = list(cs.B2_FORMS)
    for rnd in range(opts.rounds):
        print(f"round {rnd}: shipped: {times(forms + ['first'])} ms "
              f"[{card}]", flush=True)
        for v, lib in libs.items():
            restore = use_library(K, lib, ("hmsc_mvn_prec_small",))
            try:
                line = times(forms)
            finally:
                restore()
            what = SRC_VARIANTS[v][0] if v in SRC_VARIANTS else opts.older
            print(f"round {rnd}: source {v} ({what}): {line} ms [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
