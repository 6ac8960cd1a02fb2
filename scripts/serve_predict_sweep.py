#!/usr/bin/env python3
"""Where kernel B9a's time goes (``hmsc_tpu_torch/csrc/serve_predict.cu``),
on one CUDA card.

    python3 scripts/serve_predict_sweep.py [--sass DIR]

Compiles copies of the kernel's source into ``build/predict_variants/``,
each with one part cut out or changed, prints each copy's registers and
spills, and times each (torch.profiler, the main kernel alone) at the
headline posterior's shapes (chip_smoke.py's ``serve_inputs``: 800 draws,
nc 2, nf 8, 1000 species) at B 64 and B 1, expected moments and draws
mode.  The copies that compute the same function are held against the
plain version (1e-5); the diagnostic ones (a part cut out) are only
timed.  (``scripts/serve_kernel_sweep.py`` sweeps the draw-chunk split.)
With ``--sass DIR`` it writes the SASS of the shipped float32 expected
kernels to DIR (cuobjdump from the CUDA toolkit or Triton's copy).  Each
line carries the card's name and power limit.  It measures; it changes
nothing in the package.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# name -> (what it is, [(pattern, replacement)], computes the same function,
# ops.serve constants the copy needs: its geometry)
VARIANTS = {
    "shipped": ("the kernel as built", [], True, {}),
    "no_link": ("diagnostic: ndtr / exp links cut (identity)", [
        ("out[t] = normcdff(acc[t][h]);", "out[t] = acc[t][h];"),
        ("out[t] = expf(acc[t][h] + half);", "out[t] = acc[t][h] + half;")],
        False, {}),
    "no_compute": ("diagnostic: staging and barriers only", [
        ("if (nn >= d1) continue;", "if (nn >= d1 || d1 > 0) continue;")],
        False, {}),
    "skeleton": ("diagnostic: no copies and no compute", [
        ("if (nn >= d1) continue;", "if (nn >= d1 || d1 > 0) continue;"),
        ("auto issue = [&](int st) {",
         "auto issue = [&](int st) {\n    if (d1 > 0) return;")],
        False, {}),
    "three_blocks": ("__launch_bounds__(256, 3): 85 registers", [
        ("__launch_bounds__(kMaxWarps * 32, 2)",
         "__launch_bounds__(kMaxWarps * 32, 3)")], True, {}),
    "w16_rb4": ("16 warps a block of 4 rows each (64 registers)", [
        ("constexpr int kMaxWarps = 8;", "constexpr int kMaxWarps = 16;")],
        True, {"_PREDICT_WARPS": 16, "_PREDICT_ROWS_A_WARP": 4}),
    "stages3": ("a ring of 3 stages", [
        ("constexpr int kStages = 4;", "constexpr int kStages = 3;")], True,
        {"_PREDICT_STAGES": 3}),
    "stages6": ("a ring of 6 stages", [
        ("constexpr int kStages = 4;", "constexpr int kStages = 6;")], True,
        {"_PREDICT_STAGES": 6}),
}


def build(names):
    from hmsc_tpu_torch.kernels import _CSRC, _FLAGS, _nvcc

    src = (_CSRC / "serve_predict.cu").read_text()
    out = ROOT / "build" / "predict_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        s = src
        for pat, rep in VARIANTS[name][1]:
            assert pat in s, (name, pat)
            s = s.replace(pat, rep)
        cu = out / f"serve_predict_{name}.cu"
        cu.write_text(s)
        so = cu.with_suffix(".so")
        procs.append((name, so, subprocess.Popen(
            [_nvcc(), *_FLAGS, "-shared", "-I", str(_CSRC), "-Xptxas", "-v",
             str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, p in procs:
        log, _ = p.communicate()
        assert p.returncode == 0, log
        entry, regs = None, []
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = "IfLi8ELb1" in ln or "IfLi4ELb1" in ln
            elif entry and ("Used" in ln or "spill" in ln):
                regs.append(ln.split(":", 1)[-1].strip())
        print(f"{name}: float32 expected, 8 and 4 rows a warp: "
              f"{'; '.join(regs)}",
              flush=True)
        libs[name] = (ctypes.CDLL(str(so)), so)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass", default=None)
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("serve_predict_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hmsc_tpu_torch import kernels as K
    from hmsc_tpu_torch.ops import serve as tserve

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    main_lib = K.library()
    argtypes = main_lib.hmsc_serve_predict.argtypes
    inputs = {B: cs.serve_inputs(torch, dev, B, seed=40 + B) for B in (64, 1)}
    plain = {B: cs._plain_moments(torch, tserve, a, True)
             for B, a in inputs.items()}
    libs = build(list(VARIANTS))
    if opts.sass:
        tool = cs.cuobjdump()
        outdir = pathlib.Path(opts.sass)
        outdir.mkdir(parents=True, exist_ok=True)
        if tool is None:
            print("no cuobjdump: no SASS written")
        else:
            r = subprocess.run([tool, "-sass", str(libs["shipped"][1])],
                               capture_output=True, text=True, check=True)
            keep, parts = False, []
            for ln in r.stdout.splitlines():
                if "Function :" in ln:
                    keep = "serve_predict_kernelIfLi" in ln and "ELb1E" in ln
                if keep:
                    parts.append(ln)
            (outdir / "serve_predict.sass").write_text("\n".join(parts))
            print(f"SASS of the float32 expected kernels ({len(parts)} "
                  f"lines) written by {tool}")
    try:
        for name, (what, _, same, consts) in VARIANTS.items():
            lib = libs[name][0]
            lib.hmsc_serve_predict.argtypes = argtypes
            lib.hmsc_serve_predict.restype = ctypes.c_int
            K._lib = lib
            saved = {k: getattr(tserve, k) for k in consts}
            for k, v in consts.items():
                setattr(tserve, k, v)
            row = []
            for B, args in inputs.items():
                g = tserve.predict_geometry(cs.SERVE["n"], B, cs.SERVE["ns"],
                                            cs.SERVE["nc"], cs.SERVE["nf"])
                if same:
                    mk, sk, yk = tserve.serve_predict(*args, expected=True,
                                                      draws=True)
                    mp, sp, yp = plain[B]
                    err = max((mk - mp).abs().max().item(),
                              (sk - sp).abs().max().item(),
                              (yk - yp).abs().max().item())
                    assert err <= 1e-5, (name, B, err)
                mom = cs.device_ms(torch, lambda: tserve.serve_predict(
                    *args, expected=True), "serve_predict_kernel")
                drw = cs.device_ms(torch, lambda: tserve.serve_predict(
                    *args, expected=True, moments=False, draws=True),
                    "serve_predict_kernel")
                smp = cs.device_ms(torch, lambda: tserve.serve_predict(
                    *args, expected=False), "serve_predict_kernel")
                row.append(f"B {B} ({g.rb} rows a warp, {g.wr} x {g.wd} "
                           f"warps, {g.S} chunks): moments {mom:.4f} ms, "
                           f"draws mode {drw:.4f} ms, sampled {smp:.4f} ms")
            for k, v in saved.items():
                setattr(tserve, k, v)
            print(f"{name} ({what}): " + "; ".join(row) + f" [{card}]",
                  flush=True)
    finally:
        K._lib = main_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
