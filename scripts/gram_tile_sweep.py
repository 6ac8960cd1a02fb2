#!/usr/bin/env python3
"""Tile and split sweep of kernel B6 (``hmsc_tpu_torch/csrc/masked_gram.cu``)
on one CUDA card.

    python3 scripts/gram_tile_sweep.py

Compiles copies of the kernel's source with other tiles (TM outputs a
thread, so 8 TM outputs a block; BK reduction rows a tile; at least MB
blocks an SM in the registers' bound) into
``build/gram_variants/`` and prints each copy's registers and spills.
Then, for each copy and each target block count of the k split
(``ops/gram.py · gram_splits``), it checks the wrapper's results against
the plain einsum pair (1e-4 of the largest entry) on the 1000 x 1000
missing-value headline's operands (4 chains, 10% of the cells missing)
and prints the device time per call (torch.profiler, both launches)
beside one ``torch.einsum`` for G, at the per-species form (P 10) and the
per-row form (P 8).  It measures; it changes nothing in the package.
"""

import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (TM, BK, MB); the first is the shipped kernel's
VARIANTS = [(8, 16, 4), (8, 16, 1), (8, 16, 5), (4, 16, 5), (8, 32, 3)]
TARGETS = (528, 1056)
FORMS = (("species", 10), ("row", 8))


def build(variants):
    from hmsc_tpu_torch.kernels import _nvcc

    src = (ROOT / "hmsc_tpu_torch/csrc/masked_gram.cu").read_text()
    out = ROOT / "build" / "gram_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for var in variants:
        s = src
        for name, val in zip(("kTM", "kBK", "kMinBlocks"), var):
            s, n = re.subn(rf"constexpr int {name} = \d+;",
                           f"constexpr int {name} = {val};", s)
            assert n == 1, name
        cu = out / ("masked_gram_%d_%d_%d.cu" % var)
        cu.write_text(s)
        procs.append((cu.with_suffix(".so"), subprocess.Popen(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             "-Xptxas", "-v", str(cu), "-o", str(cu.with_suffix(".so"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for (so, p), var in zip(procs, variants):
        log, _ = p.communicate()
        assert p.returncode == 0, log
        regs = [re.sub(r"ptxas info\s*: ", "", ln.strip())
                for ln in log.splitlines() if "registers" in ln or
                "spill" in ln]
        print(var, "registers and spills (NG 8 .. 1, sum, columns):", regs,
              flush=True)
        libs.append(ctypes.CDLL(str(so)))
    return libs


def main() -> int:
    import torch

    import chip_smoke as cs
    from hmsc_tpu_torch import kernels as K
    from hmsc_tpu_torch.ops import gram as tgram

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    main_lib = K.library()
    argtypes = main_lib.hmsc_masked_gram.argtypes
    shipped = (tgram._BO, tgram._BK, tgram._TARGET_BLOCKS)
    inputs = {}
    for form, P in FORMS:
        mask, XE, Z, lam, iSigma = cs.gram_inputs(torch, dev, 4, 1000, 1000,
                                                  P, seed=P)
        args = ((XE, mask.T, Z.transpose(1, 2), None) if form == "species"
                else (lam.transpose(1, 2), mask, Z, iSigma))
        v, w, _, a = args
        wa = (w[None] if a is None else w[None] * a[:, None, :]).expand(
            v.shape[0], -1, -1)
        lib_ms = cs.device_ms(torch, lambda: torch.einsum(
            "cok,ckp,ckq->copq", wa, v, v), calls=10)
        inputs[form] = (args, tgram._masked_gram_plain(*args))
        print(f"{form} form, P {P}: one torch.einsum for G {lib_ms:.4f} ms "
              f"[{card}]", flush=True)
    try:
        for var, lib in zip(VARIANTS, build(VARIANTS)):
            lib.hmsc_masked_gram.argtypes = argtypes
            lib.hmsc_masked_gram.restype = ctypes.c_int
            K._lib = lib
            tgram._BO, tgram._BK = 8 * var[0], var[1]
            for target in TARGETS:
                tgram._TARGET_BLOCKS = target
                row = []
                for form, P in FORMS:
                    args, (Gp, Rp) = inputs[form]
                    G, R = tgram.masked_gram(*args)
                    err = max((G - Gp).abs().max().item()
                              / Gp.abs().max().item(),
                              (R - Rp).abs().max().item()
                              / Rp.abs().max().item())
                    assert err <= 1e-4, (var, target, form, err)
                    ms = cs.device_ms(torch, lambda: tgram.masked_gram(*args))
                    S, _ = tgram.gram_splits(4, 1000, 1000, P)
                    row.append(f"{form} {ms:.4f} ms ({S} splits, err "
                               f"{err:.2g})")
                print(f"TM {var[0]} BK {var[1]} MB {var[2]}, target {target} "
                      f"blocks: "
                      + "; ".join(row),
                      flush=True)
    finally:
        K._lib = main_lib
        tgram._BO, tgram._BK, tgram._TARGET_BLOCKS = shipped
    return 0


if __name__ == "__main__":
    sys.exit(main())
