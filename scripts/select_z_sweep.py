#!/usr/bin/env python3
"""Where kernels B9c (``hmsc_tpu_torch/csrc/serve_quantile.cu``, the draw
quantiles by selection) and B5 (``csrc/poisson_z.cu``, the whole Z update
of a model with Poisson columns) spend their time, on one CUDA card.

    python3 scripts/select_z_sweep.py [--b9c-source a,b] [--b5-source a,b]
        [--b9c-older FILE] [--b5-older FILE] [--layout large,small]
        [--rounds N]

It prints, in turns for ``--rounds N`` rounds, each kernel's device time
(torch.profiler, the kernel alone) at ``chip_smoke.py``'s shapes: B9c on
800 x 64 x 1000 draws (the serve path's 64-row query), 800 x 1 x 1000, 37
and 1025 draws x 64 x 1000 and 40000 x 3 x 50, three quantiles; B5 at 4 x
1000 x 1000 (every column Poisson), at config 5's 4 x 300 x 90 with only
its 30 Poisson columns drawn (``ops.rand.poisson_z``) and with every column
(config 5's Z update); beside them the first versions (``scripts/older/``,
built here), which draw the Poisson columns alone.
``--layout large,small`` times B5 with a thread 4 rows of 4 columns and 1
row of 2 at every shape (``ops.rand.z_geometry`` chooses by size).
``--b9c-source`` / ``--b5-source`` build copies of the shipped sources
with a part changed (``B9C_VARIANTS``, ``B5_VARIANTS``): the ones that
compute the same function are first held against the plain version (B9c
exactly, B5 to 1e-4 with injected draws).  ``--b9c-older`` /
``--b5-older`` build an older source of the shipped kernel with the same
C interface (put it inside the repository, e.g. under ``build/``) and time
it in the same turns, so that an edit is timed against the source before
it in one process.  Each line carries the card's name and power limit.  It
measures; it changes nothing in the package.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

# copies of the sources: name -> (what, [(regex, replacement)], computes
# the same function)
B9C_VARIANTS = {
    "match_any": ("histogram increments aggregated by __match_any_sync", [
        (r"      atomicAdd\(h \+ hidx\(\(key >> shift\) & dmask\), 1u\);",
         "      const unsigned hb = hidx((key >> shift) & dmask);\n"
         "      const unsigned peers = __match_any_sync(__activemask(), hb);\n"
         "      if (__ffs(peers) - 1 == (threadIdx.x & 31))\n"
         "        atomicAdd(h + hb, static_cast<unsigned>(__popc(peers)));")],
        True),
    "few32": ("sets of at most 32 keys ranked, not 64", [
        (r"constexpr int kFew = 64;", "constexpr int kFew = 32;")], True),
    "buf512": ("a buffer of 512 keys a warp, not 320 (3 blocks an SM at "
               "800 draws, not 4)", [
        (r"constexpr int kBuf = 320;", "constexpr int kBuf = 512;")], True),
    "cols16": ("16 columns (and warps) a block: 64-byte draw rows", [
        (r"constexpr int kLogCols = 3;", "constexpr int kLogCols = 4;"),
        (r"  if \(n < 1 \|\| nq < 0 \|\| nq > kMaxQ \|\| cols < 0 \|\|\n"
         r"      \(staged && n > kStagedMax\)\)",
         "  staged = staged && n <= kStagedMax;\n"
         "  if (n < 1 || nq < 0 || nq > kMaxQ || cols < 0)")], True),
    "cols32": ("32 columns (and warps) a block: 128-byte draw rows, one "
               "block an SM, staged up to 946 draws", [
        (r"constexpr int kLogCols = 3;", "constexpr int kLogCols = 5;"),
        (r"constexpr int kStagedMax = 2048;", "constexpr int kStagedMax = 946;"),
        (r"  if \(n < 1 \|\| nq < 0 \|\| nq > kMaxQ \|\| cols < 0 \|\|\n"
         r"      \(staged && n > kStagedMax\)\)",
         "  staged = staged && n <= kStagedMax;\n"
         "  if (n < 1 || nq < 0 || nq > kMaxQ || cols < 0)")], True),
    "stage_only": ("the staging and first pass alone (quantiles not "
                   "written)", [
        (r"(  const bool any_nan = bad;\n)",
         r"\1  if (a.nq > 0) return;\n")], False),
    "to_h1": ("up to the level-1 histogram and the ranks' bins", [
        (r"(      const unsigned pmask = pmask0 \| \(dmask1 << shift1\);\n)",
         r"\1      if (a.nq > 0) return;\n")], False),
    "to_gather": ("up to the first gather", [
        (r"(        __syncwarp\(\);\n        for \(int t = 0; t < m; \+\+t\)\n)",
         r"        if (a.nq > 0) return;\n\1")], False),
}
B5_VARIANTS = {
    "sincospif": ("the angle by sincospif on [0, 2), not the fast "
                  "__sincosf", [
        (r"__sincosf\(fmaf\(static_cast<float>\(b1 >> 8\), "
         r"6\.2831853f / 16777216\.0f,\n\s*-3\.14159265f\), &s, &c\);",
         "sincospif(static_cast<float>(b1 >> 8) * (2.0f / 16777216.0f), "
         "&s, &c);")], True),
    "empty": ("the launch alone (every thread returns at once)", [
        (r"(  const int c = blockIdx\.z;\n)", r"  if (a.ns > 0) return;\n\1")],
        False),
}

B9C_SHAPES = ((800, 64, 1000), (800, 1, 1000), (37, 64, 1000),
              (1025, 64, 1000), (40000, 3, 50))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b9c-source", default="")
    ap.add_argument("--b5-source", default="")
    ap.add_argument("--b9c-older", default="")
    ap.add_argument("--b5-older", default="")
    ap.add_argument("--layout", default="")
    ap.add_argument("--rounds", type=int, default=1)
    opts = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("select_z_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hmsc_tpu_torch import kernels as K
    from hmsc_tpu_torch.ops import rand as trand
    from hmsc_tpu_torch.ops import serve as tserve
    from probit_z_sweep import build_variants, use_library

    card = cs.card_line()
    print(card)
    dev = torch.device("cuda", 0)
    K.library()
    first_q = cs.build_source("scripts/older/serve_quantile.cu",
                              "serve_quantile_first")
    first_z = cs.build_source("scripts/older/poisson_z.cu", "poisson_z_first")
    q = torch.tensor(cs.SERVE_Q, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    draws = {s: torch.rand(s, generator=g, device=dev) for s in B9C_SHAPES}
    C, ny, ns = cs.HEADLINE["n_chains"], cs.HEADLINE["ny"], cs.HEADLINE["ns"]
    Y, Zp, E, iS, _, e1, e2 = cs.poisson_inputs(torch, dev, C, ny, ns, 5)
    fam3 = torch.full((ns,), 3, dtype=torch.int32, device=dev)
    n5, s5 = cs.CONFIG5["ny"], cs.CONFIG5["ns"]
    Y5, Z5, E5, iS5, _, _, _ = cs.poisson_inputs(torch, dev, C, n5, s5, 6)
    fam5 = cs.config5_families(torch, dev)
    rng = trand.Rng(5, dev)

    libs = {"b9c": {}, "b5": {}}
    for kind, names, table, src_name, tag in (
            ("b9c", opts.b9c_source, B9C_VARIANTS, "serve_quantile.cu",
             "serve_quantile"),
            ("b5", opts.b5_source, B5_VARIANTS, "poisson_z.cu",
             "poisson_z")):
        picked = [v for v in names.split(",") if v]
        if picked:
            src = (K._CSRC / src_name).read_text()
            libs[kind].update({v: lib for v, (lib, _) in build_variants(
                src, {v: table[v][1] for v in picked}, tag, tag).items()})
    if opts.b9c_older:
        libs["b9c"]["older"] = build_variants(
            pathlib.Path(opts.b9c_older).read_text(), {"older": []},
            "serve_quantile_older", "serve_quantile")["older"][0]
    if opts.b5_older:
        libs["b5"]["older"] = build_variants(
            pathlib.Path(opts.b5_older).read_text(), {"older": []},
            "poisson_z_older", "poisson_z")["older"][0]
    names = {"b9c": ("hmsc_serve_quantile",),
             "b5": ("hmsc_z_mixed",)}

    # the copies that compute the same function, against the plain version
    y = draws[(800, 64, 1000)]
    spec = cs.b9c_specials(torch, dev, 1025, 3, 50, seed=1)
    args5, nz5 = cs.mixed_inputs(torch, dev, C, n5, s5, seed=9, na=0.1)
    for kind in ("b9c", "b5"):
        for v, lib in libs[kind].items():
            table = B9C_VARIANTS if kind == "b9c" else B5_VARIANTS
            if v in table and not table[v][2]:
                continue
            restore = use_library(K, lib, names[kind])
            try:
                if kind == "b9c":
                    for w in (y, spec):
                        assert cs._b9c_equal(
                            tserve.draw_quantiles(w, q),
                            tserve._draw_quantiles_plain(w, q)), v
                    err = 0.0
                else:
                    zk = trand.poisson_z(Y5, Z5, E5, iS5, fam5, eps_pg=e1[
                        :, :n5, :s5].contiguous(), eps_z=e2[
                        :, :n5, :s5].contiguous())
                    zp = trand._poisson_z_plain(
                        Y5, Z5, E5, iS5, fam5, e1[:, :n5, :s5],
                        e2[:, :n5, :s5])
                    err = ((zk - zp).abs() / zp.abs().clamp_min(1.0)).max()
                    assert err <= 1e-4, f"{v}: {err}"
                    zm = trand.z_mixed(*args5, **nz5)
                    ok = (fam5 != 2)
                    zmp = trand._z_mixed_plain(*args5, **nz5)
                    err = max(float(err), float(
                        ((zm - zmp).abs() / zmp.abs().clamp_min(1.0))[
                            ..., ok].max()))
                    assert err <= 1e-4, f"{v} mixed: {err}"
            finally:
                restore()
            print(f"{kind} source {v}: agrees with the plain version "
                  f"({'exactly' if kind == 'b9c' else format(err, '.3g')})",
                  flush=True)

    def b9c_times(first=False):
        out = []
        for s in B9C_SHAPES:
            w = draws[s]
            if first and s[0] > 32768:
                out.append(f"{s[0]}x{s[1]}x{s[2]} -")
                continue
            fn = ((lambda w=w: cs.first_b9c(torch, first_q, w, q)) if first
                  else (lambda w=w: tserve.draw_quantiles(w, q)))
            out.append(f"{s[0]}x{s[1]}x{s[2]} " + format(cs.device_ms(
                torch, fn, "serve_quantile_kernel"), ".5f"))
        return "; ".join(out)

    def b5_times(first=False):
        if first:
            calls = {
                "4x1000x1000": lambda: cs.first_b5(
                    torch, first_z, Y, Zp, E, iS, fam3, *rng.philox()),
                "Poisson columns config 5": lambda: cs.first_b5(
                    torch, first_z, Y5, Z5, E5, iS5, fam5, *rng.philox())}
        else:
            calls = {
                "4x1000x1000": lambda: trand.z_mixed(
                    Y, Zp, E, iS, fam3, None, rng),
                "Poisson columns config 5": lambda: trand.poisson_z(
                    Y5, Z5, E5, iS5, fam5, rng),
                "config 5": lambda: trand.z_mixed(
                    Y5, Z5, E5, iS5, fam5, None, rng)}
        return "; ".join(f"{k} " + format(cs.device_ms(
            torch, f, "poisson_z_kernel"), ".5f") for k, f in calls.items())

    layouts = [v for v in opts.layout.split(",") if v]
    base_cells = trand._B5_LARGE_CELLS
    for rnd in range(opts.rounds):
        print(f"round {rnd}: B9c shipped: {b9c_times()} ms [{card}]",
              flush=True)
        print(f"round {rnd}: B9c first version: {b9c_times(True)} ms "
              f"[{card}]", flush=True)
        for v, lib in libs["b9c"].items():
            restore = use_library(K, lib, names["b9c"])
            try:
                line = b9c_times()
            finally:
                restore()
            what = B9C_VARIANTS[v][0] if v in B9C_VARIANTS else opts.b9c_older
            print(f"round {rnd}: B9c source {v} ({what}): {line} ms "
                  f"[{card}]", flush=True)
        print(f"round {rnd}: B5 shipped: {b5_times()} ms [{card}]",
              flush=True)
        print(f"round {rnd}: B5 first version: {b5_times(True)} ms "
              f"[{card}]", flush=True)
        for lay in layouts:
            trand._B5_LARGE_CELLS = 0 if lay == "large" else 1 << 62
            try:
                line = b5_times()
            finally:
                trand._B5_LARGE_CELLS = base_cells
            print(f"round {rnd}: B5 in the {lay} layout: {line} ms "
                  f"[{card}]", flush=True)
        for v, lib in libs["b5"].items():
            restore = use_library(K, lib, names["b5"])
            try:
                line = b5_times()
            finally:
                restore()
            what = B5_VARIANTS[v][0] if v in B5_VARIANTS else opts.b5_older
            print(f"round {rnd}: B5 source {v} ({what}): {line} ms "
                  f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
