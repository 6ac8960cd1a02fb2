#!/usr/bin/env python3
"""Where kernel B8c's time goes (``hmsc_tpu_torch/csrc/nngp_riw.cu``: the
dense NNGP precision iW = RiW' RiW in one launch), on one CUDA card.

    python3 scripts/nngp_dense_iw_sweep.py [--rows 8,16] [--rounds N]
        [--source a,b] [--older FILE] [--phases]

Times B8c (torch.profiler, the kernel alone) at ``chip_smoke.py``'s B8c
shapes (4 chains; np 97, 100 and 128 at nf 2, np 256 at nf 1, 10
neighbours; np 100 at nf 2 with 40) with each ``--rows`` (rows of iW a
block, a warp a row: ``ops.spatial._IW_ROWS`` set in turn), in turns with
an older source of the kernel on the same inputs in one process:
``--older FILE`` (default ``scripts/older/nngp_riw_factor.cu``, the first
version, which writes the factor RiW through its own C interface,
``hmsc_nngp_riw``, then forms the gram with torch.matmul: both launches
timed).  ``--rounds N`` times the list N times.  ``--source a,b`` builds
copies of the shipped source with a part cut or changed (``SRC_VARIANTS``)
and times them at the shipped rows; ``--phases`` builds a copy that
records each warp's SM cycles in the kernel's phases (``PHASES``).  Every
form is first held against the plain version (max |diff| / max |plain| <=
1e-5).  Each line carries the card's name and power limit.  It measures;
it changes nothing in the package.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

# copies of the source, each with a part cut or changed: name -> (what,
# [(regex, replacement)]); their results may be wrong, only the time is read
SRC_VARIANTS = {
    "empty": ("the launch alone (every block returns at once)", [
        (r"(  extern __shared__ float sm\[\];)",
         r"\1\n  if (a.np > 0) return;")]),
    "no_sums": ("the rows' sums cut (staging, zeroing, stores)", [
        (r"acc\[l\] = fmaf\(rij, (\w+), acc\[l\]\);",
         r"(void)rij; (void)\1;")]),
    "own_only": ("each row's own unit's term only (no reverse neighbours)", [
        (r"const int eb = rp\[warp\], ee = rp\[warp \+ 1\];",
         "const int eb = rp[warp], ee = rp[warp];")]),
    "ieee_staging": ("scaled coefficients by IEEE sqrt and division, not "
                     "rsqrtf (the plain version's bits)", [
        (r"-cr\[u\] \* rsqrtf\(dr\[u\]\)", "-cr[u] / sqrtf(dr[u])"),
        (r"di\[i\] = rsqrtf\(__ldg\(Da \+ i\)\);",
         "di[i] = 1.0f / sqrtf(__ldg(Da + i));")]),
}

# a copy that writes each warp's SM cycles in the staging (up to the
# barrier), its row's sums and its row's stores over the row's first three
# entries
PHASES = [
    (r"(  extern __shared__ float sm\[\];)",
     r"\1\n  const long long clk0 = clock64();"),
    (r"(  __syncthreads\(\);\n)(  const int warp = threadIdx\.x >> 5)",
     r"\1  const long long clk1 = clock64();\n\2"),
    (r"(  float\* out = a\.out \+ \(static_cast<long long>\(cf\) \* np \+ j\)"
     r" \* np;\n)", r"  const long long clk2 = clock64();\n\1"),
    (r"(  for \(int l = lane; l < np; l \+= 32\) out\[l\] = acc\[l\];\n)",
     r"\1  __syncwarp();\n  if (lane == 0) {\n    out[0] = float(clk1 - clk0);"
     r"\n    out[1] = float(clk2 - clk1);\n"
     r"    out[2] = float(clock64() - clk2);\n  }\n"),
]


def phases(torch, cs, K, tsp, cases, card):
    """Each warp's SM cycles in B8c's phases, from a copy of the source
    (``PHASES``): median and largest over the rows, at each shape."""
    from probit_z_sweep import build_variants, use_library

    src = (K._CSRC / "nngp_riw.cu").read_text()
    lib = build_variants(src, {"phases": PHASES}, "nngp_riw", "nngp_iw")
    restore = use_library(K, lib["phases"][0], ("hmsc_nngp_iw",))
    hz = cs.sm_clock_hz()
    try:
        for n, nf, lvd, alpha, _ in cases:
            for _ in range(3):
                out = tsp.nngp_riw_dense(lvd, alpha)
            torch.cuda.synchronize()
            cyc = out[..., :3].reshape(-1, 3).double().cpu()
            med = cyc.median(dim=0).values.tolist()
            top = cyc.max(dim=0).values.tolist()
            print(f"phases np {n} nf {nf} k {lvd.nn_idx.shape[1]} (SM "
                  f"cycles, median / largest over rows; SM clock "
                  f"{hz / 1e9:.2f} GHz): staging {med[0]:.0f}"
                  f" / {top[0]:.0f}, the row's sums {med[1]:.0f} / "
                  f"{top[1]:.0f}, its stores {med[2]:.0f} / {top[2]:.0f} "
                  f"[{card}]", flush=True)
    finally:
        restore()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="8")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--source", default="")
    ap.add_argument("--older", default=None)
    ap.add_argument("--phases", action="store_true",
                    help="print each warp's cycles in B8c's phases")
    opts = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("nngp_dense_iw_sweep: no CUDA device is available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hmsc_tpu_torch import kernels as K
    from hmsc_tpu_torch.ops import spatial as tsp

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    dev = torch.device("cuda", 0)
    K.library()
    older = cs.build_source(
        opts.older or cs.B8C_FIRST_SOURCE, "nngp_riw_older")
    cases = []
    for n, nf, k in cs.B8C_SHAPES:
        lvd = cs.nngp_level(torch, dev, n, k, 10.0, seed=n)
        g = torch.Generator(device=dev).manual_seed(n + 3)
        alpha = torch.randint(0, cs.B8_G, (cs.B8_C, nf), generator=g,
                              device=dev, dtype=torch.int32)
        alpha[0, 0] = 0
        plain = tsp._nngp_riw_dense_plain(lvd, alpha)
        err = cs._rel(cs.first_b8c(torch, older, lvd, alpha), plain)
        assert err <= 1e-5, f"older np {n}: {err}"
        cases.append((n, nf, lvd, alpha, plain))
    rows = [int(r) for r in opts.rows.split(",")]
    shipped_rows = tsp._IW_ROWS
    for n, nf, lvd, alpha, plain in cases:
        for r in rows:
            tsp._IW_ROWS = r
            err = cs._rel(tsp.nngp_riw_dense(lvd, alpha), plain)
            assert err <= 1e-5, f"rows {r} np {n}: {err}"
    tsp._IW_ROWS = shipped_rows
    for rnd in range(opts.rounds):
        for n, nf, lvd, alpha, _ in cases:
            line = []
            for r in rows:
                tsp._IW_ROWS = r
                ms = cs.device_ms(torch, lambda: tsp.nngp_riw_dense(
                    lvd, alpha), "nngp_iw_kernel")
                line.append(f"rows {r} {ms:.5f} ms")
            tsp._IW_ROWS = shipped_rows
            old = cs.device_ms(torch, lambda: cs.first_b8c(
                torch, older, lvd, alpha))
            print(f"round {rnd}: C {cs.B8_C}, nf {nf}, np {n}, k "
                  f"{lvd.nn_idx.shape[1]}: "
                  + ", ".join(line) + f"; older source and its gram "
                  f"{old:.5f} ms [{card}]", flush=True)
    if opts.phases:
        phases(torch, cs, K, tsp, cases, card)
    names = [v for v in opts.source.split(",") if v]
    if names:
        from probit_z_sweep import build_variants, use_library

        src = (K._CSRC / "nngp_riw.cu").read_text()
        libs = build_variants(src, {v: SRC_VARIANTS[v][1] for v in names},
                              "nngp_riw", "nngp_iw")
        for v in names:
            restore = use_library(K, libs[v][0], ("hmsc_nngp_iw",))
            try:
                line = []
                for n, nf, lvd, alpha, _ in cases:
                    ms = cs.device_ms(torch, lambda: tsp.nngp_riw_dense(
                        lvd, alpha), "nngp_iw_kernel")
                    line.append(f"np {n} nf {nf} k {lvd.nn_idx.shape[1]}: "
                                f"{ms:.5f} ms")
            finally:
                restore()
            print(f"source {v} ({SRC_VARIANTS[v][0]}): " + "; ".join(line)
                  + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
