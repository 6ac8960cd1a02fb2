#!/usr/bin/env python3
"""Where kernel B8d-3's time goes (``hmsc_tpu_torch/csrc/gpp_quad.cu``), on
one CUDA card.

    python3 scripts/gpp_quad_sweep.py [--variants a,b] [--rounds N]

Compiles copies of the kernel's source into ``build/quad_variants/``, each
with one part changed or cut out, prints each copy's registers and spills,
and times each one's two launches (torch.profiler: the first pass over
unit ranges, the second over iF) in grid mode and at alpha, at config
3c's shapes (chip_smoke.py's ``gpp_level``: C 4, np 1000, nK 100, nf 2,
alpha indices 0, 50, 100).  The copies that keep the kernel's order of
summation must give the shipped kernel's bits; the diagnostic ones (a
part cut out) are only timed.  Each line carries the card's name and power
limit.  ``--variants`` builds only the named copies; ``--rounds N`` times
them N times in turn (a, b, a, b, ...), so that two copies are compared
within one call.  It measures; it changes nothing in the package.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# name -> (what it is, [(pattern, replacement, count)], same bits)
VARIANTS = {
    "shipped": ("the kernel as built", [], True),
    "no_bulk": ("first pass: per-thread cp.async, no bulk copies", [
        ("  const bool bulk = a.nK % 2 == 0 &&",
         "  const bool bulk = a.nK < 0 &&", 1)], True),
    "p_stages5": ("first pass: a ring of 5 stages", [
        ("constexpr int kStages1 = 4;", "constexpr int kStages1 = 5;", 1)],
        True),
    "f_tr10": ("second pass: stages of 10 iF rows", [
        ("constexpr int kRing2Doubles = 2800;",
         "constexpr int kRing2Doubles = 4000;", 1)], True),
    "f_s8": ("second pass: a ring of 8 stages", [
        ("constexpr int kStages2 = 4;", "constexpr int kStages2 = 8;", 1)],
        True),
    "f_s16_tr15": ("second pass: all of iF in flight (16 stages of 15 rows)",
                   [("constexpr int kStages2 = 4;",
                     "constexpr int kStages2 = 16;", 1),
                    ("constexpr int kRing2Doubles = 2800;",
                     "constexpr int kRing2Doubles = 1500;", 1)], True),
    "f_s16_tr2": ("second pass: a ring of 16 stages of 2 iF rows", [
        ("constexpr int kStages2 = 4;", "constexpr int kStages2 = 16;", 1),
        ("constexpr int kRing2Doubles = 2800;",
         "constexpr int kRing2Doubles = 200;", 1)], True),
    "f_nothing": ("diagnostic: second pass returns at once", [
        ("  const int g = blockIdx.x, cz = blockIdx.y;\n",
         "  if (a.U > 0) return;\n  const int g = blockIdx.x, cz = "
         "blockIdx.y;\n", 1),
        ("  const int col = blockIdx.x;\n  const long long av = a.alpha[col];"
         "\n  const int TR",
         "  if (a.U > 0) return;\n  const int col = blockIdx.x;\n  const "
         "long long av = a.alpha[col];\n  const int TR", 1)], False),
    "f_early": ("diagnostic: second pass returns after its first loads", [
        ("  if (a.alphapw[2 * g] == 0.0f) {  // W = I: eta' eta",
         "  if (a.U > 0) { cp_wait<0>(); return; }\n"
         "  if (a.alphapw[2 * g] == 0.0f) {  // W = I: eta' eta", 1),
        ("  if (a.alphapw[2 * av] == 0.0f) {  // W = I: (eta' eta, np,",
         "  if (a.U > 0) { cp_wait<0>(); return; }\n"
         "  if (a.alphapw[2 * av] == 0.0f) {  // W = I: (eta' eta, np,", 1)],
        False),
    "f_no_stream": ("diagnostic: second pass without iF", [
        ("ring_start<kStages2>(iF, a.nK,", "ring_start<kStages2>(iF, 0,", 4),
        ("ring_run<kStages2, QT>(iF, a.nK,", "ring_run<kStages2, QT>(iF, 0,",
         2)], False),
    "f_no_sums": ("diagnostic: second pass without the partial sums", [
        ("  sum_partials<", "  if (a.U < 0) sum_partials<", 2)],
        False),
}


def build(names):
    from hmsc_tpu_torch.kernels import _CSRC, _FLAGS, _nvcc

    src = (_CSRC / "gpp_quad.cu").read_text()
    out = ROOT / "build" / "quad_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        s = src
        for pat, rep, count in VARIANTS[name][1]:
            assert s.count(pat) == count, (name, pat)
            s = s.replace(pat, rep)
        cu = out / f"gpp_quad_{name}.cu"
        cu.write_text(s)
        so = cu.with_suffix(".so")
        procs.append((name, so, subprocess.Popen(
            [_nvcc(), *_FLAGS, "-shared", "-Xptxas", "-v", str(cu), "-o",
             str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, p in procs:
        log, _ = p.communicate()
        assert p.returncode == 0, log
        entry, regs = None, []
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = next((k for k in ("grid_partial", "grid_final",
                                          "at_partial", "at_final")
                              if f"gpp_quad_{k}_kernelILi" in ln
                              and ("ILi4E" in ln or "ILi1E" in ln)), None)
            elif entry and "Used" in ln:
                regs.append(f"{entry} {ln.split(':', 1)[-1].strip()}")
            elif entry and "spill" in ln and " 0 bytes spill stores" not in ln:
                regs.append(f"{entry} {ln.strip()}")
        print(f"{name}: " + "; ".join(regs), flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated copies to build and time")
    ap.add_argument("--rounds", type=int, default=1,
                    help="time the copies this many times in turn")
    opts = ap.parse_args(argv)
    names = opts.variants.split(",")
    if not torch.cuda.is_available():
        print("gpp_quad_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hmsc_tpu_torch import kernels as K
    from hmsc_tpu_torch.ops import spatial as tsp

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    main_lib = K.library()
    C, n, nk_side, nf, side = cs.B8D_SHAPES[0]
    lvd, _ = cs.gpp_level(torch, dev, n, nk_side, side, seed=n + 7)
    alpha = cs._gpp_alpha(torch, dev, C, nf)
    g = torch.Generator(device=dev).manual_seed(5)
    eta = torch.randn((C, n, nf), generator=g, device=dev)
    want = (tsp.gpp_quad_grid(lvd, eta), tsp.gpp_quad_at(lvd, alpha, eta))
    libs = build(names)
    try:
        for rnd, name in ((r, v) for r in range(opts.rounds) for v in names):
            what, _, same = VARIANTS[name]
            lib = libs[name]
            for fn in ("hmsc_gpp_quad_grid", "hmsc_gpp_quad_at"):
                getattr(lib, fn).argtypes = getattr(main_lib, fn).argtypes
                getattr(lib, fn).restype = ctypes.c_int
            K._lib = lib
            got = (tsp.gpp_quad_grid(lvd, eta), tsp.gpp_quad_at(lvd, alpha,
                                                                eta))
            if same:
                assert all(torch.equal(a, b) for a, b in zip(got, want)), name
            parts = []
            for mode, fn in (("grid", lambda: tsp.gpp_quad_grid(lvd, eta)),
                             ("at", lambda: tsp.gpp_quad_at(lvd, alpha,
                                                            eta))):
                t = [cs.device_ms(torch, fn, f"gpp_quad_{mode}_{k}_kernel")
                     for k in ("partial", "final")]
                parts.append(f"{mode} {t[0]:.5f} + {t[1]:.5f} = "
                             f"{sum(t):.5f} ms")
            print(f"{name} ({what}), round {rnd + 1}: " + "; ".join(parts)
                  + f" [{card}]", flush=True)
    finally:
        K._lib = main_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
