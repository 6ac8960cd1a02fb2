#!/usr/bin/env python3
"""Tile-size sweep of kernel B6 (``hmsc_tpu_torch/csrc/masked_gram.cu``) on
one CUDA card.

    python3 scripts/gram_tile_sweep.py

Compiles copies of the kernel's source with other block tiles (BO outputs
by BK reduction rows, TY thread rows) into ``build/gram_variants/``, checks
each against the plain einsum pair on the 1000 x 1000 missing-value
headline's operands (4 chains, 10% of the cells missing) and prints each
one's CUDA-event time per call beside the plain version's, at P = 4, 8
(per-row form), 10 and 18.  It measures; it changes nothing in the
package.
"""

import ctypes
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (BO, TY, BK); the first is the shipped kernel's
VARIANTS = [(64, 16, 16), (32, 16, 16), (32, 16, 32), (64, 16, 32),
            (16, 16, 32), (32, 8, 32)]
SHAPES = [(10, "species"), (8, "row"), (4, "species"), (18, "species")]


def build(variants):
    from hmsc_tpu_torch.kernels import _nvcc

    src = (ROOT / "hmsc_tpu_torch/csrc/masked_gram.cu").read_text()
    out = ROOT / "build" / "gram_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for bo, ty, bk in variants:
        s = src
        for name, val in (("BO", bo), ("TY", ty), ("BK", bk)):
            s = re.sub(rf"constexpr int {name} = \d+;",
                       f"constexpr int {name} = {val};", s)
        cu = out / f"masked_gram_{bo}_{ty}_{bk}.cu"
        cu.write_text(s)
        procs.append((cu.with_suffix(".so"), subprocess.Popen(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
             "-Xptxas", "-v", str(cu), "-o", str(cu.with_suffix(".so"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for (so, p), v in zip(procs, variants):
        log, _ = p.communicate()
        assert p.returncode == 0, log
        print(v, [ln.strip() for ln in log.splitlines() if "registers" in ln])
        fn = ctypes.CDLL(str(so)).hmsc_masked_gram
        ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, ll, ll, ll, ptr, ll, ll, ptr, ll, ll, ptr, ll, ll,
                       ll, ptr, ptr, i, i, i, i, ptr]
        libs.append(fn)
    return libs


def event_ms(torch, fn, batch=20, trials=7):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / batch)
    return statistics.median(out)


def main() -> int:
    import torch

    from hmsc_tpu_torch.ops import gram as tgram

    if not torch.cuda.is_available():
        print("gram_tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = build(VARIANTS)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    C, ny, ns = 4, 1000, 1000
    mask = (torch.rand((ny, ns), generator=g, device=dev) > 0.1).float()
    for P, form in SHAPES:
        XE = torch.randn((C, ny, P), generator=g, device=dev)
        Z = torch.randn((C, ny, ns), generator=g, device=dev)
        lam = torch.randn((C, P, ns), generator=g, device=dev)
        iS = torch.rand((C, ns), generator=g, device=dev) + 0.5
        v, w, s, a = ((XE, mask.T, Z.transpose(1, 2), None)
                      if form == "species" else
                      (lam.transpose(1, 2), mask, Z, iS))
        Gp, Rp = tgram._masked_gram_plain(v, w, s, a)
        plain_ms = event_ms(torch,
                            lambda: tgram._masked_gram_plain(v, w, s, a))
        row = [f"P={P} {form}: plain {plain_ms:.4f} ms"]
        for fn, var in zip(libs, VARIANTS):
            G = torch.empty_like(Gp)
            R = torch.empty_like(Rp)
            stream = torch.cuda.current_stream().cuda_stream

            def kern():
                code = fn(v.data_ptr(), *v.stride(), w.data_ptr(),
                          *w.stride(), None if a is None else a.data_ptr(),
                          *((0, 0) if a is None else a.stride()),
                          s.data_ptr(), *s.stride(), G.data_ptr(),
                          R.data_ptr(), C, w.shape[0], v.shape[1], P, stream)
                assert code == 0, code

            kern()
            torch.cuda.synchronize()
            err = max(((G - Gp).abs().max() / Gp.abs().max()).item(),
                      ((R - Rp).abs().max() / Rp.abs().max()).item())
            assert err <= 1e-4, (var, err)
            row.append(f"{var}: {event_ms(torch, kern):.4f} ms")
        print("; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
