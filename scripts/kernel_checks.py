#!/usr/bin/env python3
"""Run chosen kernels' card checks and times from ``chip_smoke.py`` alone.

    python3 scripts/kernel_checks.py serve_predict gpp_quad [--ptxas] [--bf16]

Builds every kernel as ``chip_smoke.py`` does, prints ``nvcc -Xptxas
-v``'s registers, shared memory and spills for the named kernels' sources
(``--ptxas``), then runs only those kernels' checks against their plain
versions and their times (``chip_smoke.py``'s phases 2-3) and prints
their numbers as one JSON line (``--bf16``: also the bf16 forms of B4,
B6, B8b and B8c against their plain versions).  Names are those of
``hmsc_tpu_torch.kernels.KERNELS``.  No model path runs and there is no
result line: ``chip_smoke.py`` is the whole run.  Each line carries the
card's name and power limit.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# checks that return several kernels' numbers: B1's two forms, B8d-1..3
_GROUPS = (("probit_z", "probit_z_fused"),
           ("gpp_unit", "gpp_knot", "gpp_quad"))


def ptxas_report(K, names):
    """``nvcc -Xptxas -v`` of the named kernels' sources (one nvcc each,
    started together, into the build directory): each kernel's registers,
    shared memory and spills, printed."""
    out = K._build_dir() / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    procs = [(n, subprocess.Popen(
        [K._nvcc(), *K._FLAGS, "-Xptxas", "-v", "-c",
         str(K._CSRC / K.KERNELS[n]), "-o", str(out / f"{n}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for n in names]
    for n, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v {n}:\n{text}")
        entry = None
        for ln in text.splitlines():
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1] if "'" in ln else ln
            elif "spill" in ln or "Used" in ln:
                print(f"ptxas {n} {entry}: {ln.strip()}")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="+", help="kernel names")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc -Xptxas -v's registers and spills")
    ap.add_argument("--bf16", action="store_true",
                    help="also run the bf16 forms' checks (B4, B6, B8b at "
                         "alpha, B8c)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_checks: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hmsc_tpu_torch import kernels as K
    from hmsc_tpu_torch.ops import gram, linalg, mixed, rand, serve, spatial

    unknown = set(opts.names) - set(K.KERNELS)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}; known: "
                 f"{list(K.KERNELS)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    K.library()
    if opts.ptxas:
        ptxas_report(K, opts.names)
    checks = {
        "mvn_prec_small": lambda: cs.check_b2(torch, linalg, rand, dev,
                                              card),
        "gamma_v": lambda: cs.check_b4(torch, rand, dev, card),
        "standard_gamma": lambda: cs.check_b3(torch, rand, dev, card),
        "shrinkage_gamma": lambda: cs.check_b3_shrinkage(torch, rand, dev,
                                                         card),
        "poisson_z": lambda: cs.check_b5(torch, rand, dev, card),
        "masked_gram": lambda: cs.check_b6(torch, gram, dev, card),
        "vecchia_apply": lambda: cs.check_b8a(torch, spatial, dev, card),
        "vecchia_site": lambda: cs.check_b8e(torch, spatial, dev, card),
        "nngp_quad": lambda: cs.check_b8b(torch, spatial, dev, card),
        "nngp_riw": lambda: cs.check_b8c(torch, spatial, dev, card),
        "truncnorm_da": lambda: cs.check_b7(torch, rand, dev, card),
        "serve_predict": lambda: cs.check_b9a(torch, serve, K, dev, card),
        "serve_quantile": lambda: cs.check_b9c(torch, serve, dev, card),
        "serve_conditional": lambda: cs.check_b9b(torch, serve, dev, card),
        "mixed_gemm": lambda: cs.check_b10(torch, mixed, dev, card)}
    results = {}
    for name in opts.names:
        if name in results:
            continue
        if name in _GROUPS[0]:
            results.update(cs.check_b1(torch, rand, dev, card))
        elif name in _GROUPS[1]:
            results.update(cs.check_b8d(torch, spatial, dev, card))
        else:
            results[name] = checks[name]()
    out = {n: results[n] for n in opts.names}
    if opts.bf16:
        out["bf16_forms"] = cs.check_bf16_forms(torch, rand, gram, spatial,
                                                dev, card)
    print(json.dumps({"kernels": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
