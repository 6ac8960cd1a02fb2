#!/usr/bin/env python3
"""Where kernel B8b's time goes (``hmsc_tpu_torch/csrc/nngp_quad.cu``), on
one CUDA card.

    python3 scripts/nngp_quad_sweep.py [--variants a,b] [--rounds N]

Times the grid-mode and at-alpha quadratics (torch.profiler, the kernel
alone) at chip_smoke.py's B8b shapes (4 chains, 101 grid points: np 1000
with 10 neighbours and nf 2 or 8, config 3b's; np 5000 with 8; np 100,
dense NNGP's) under several launch shapes: ``ops.spatial.quad_geometry``
with fields overridden (``VARIANTS``: eta read in place instead of
staged).  Every shape is first held against the plain
version (1e-5) and run twice to the same bits.  It also prints the static
SASS instruction count of each kernel (``cuobjdump -sass``).  ``--rounds
N`` times the list N times in turn, so two shapes are compared within one
call.  ``--source a,b`` then builds copies of the source with a part cut
or changed (``SRC_VARIANTS``: the units' terms, the at-alpha cluster step,
grid mode's variance loaded after the gathers, a cluster launch
attribute, unrolled unit loops, fewer slots loaded together, smaller blocks, scalar gathers)
and times them at the shipped shapes.  ``--older FILE`` builds an older source of the kernel
(``_OLDER_GRID``, ``_OLDER_AT``: its C interface) and times it in turns
with the shipped kernel on the same inputs, in one process.  Each line
carries the card's name and power limit.
It measures; it changes nothing in the package.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


# name -> (what, ops.spatial constants, grid-mode override(q))
VARIANTS = {
    "shipped": ("the launch as shipped", {}, None),
    "eta_global": ("eta read in place (L1 / L2), not staged", {},
                   lambda q: dict(q, eta_smem=False)),
}


# copies of the source, each with a part cut or changed: name -> (what,
# [(regex, replacement)]); their results are wrong, only the time is read
SRC_VARIANTS = {
    "no_units": ("the units' terms cut (copies and reductions only)", [
        (r"for \(int i = threadIdx\.x; i < np; i \+= kGridThreads\)",
         "for (int i = threadIdx.x; i < 0; i += kGridThreads)"),
        (r"for \(int i = u0 \+ threadIdx\.x; i < u1; i \+= T\)",
         "for (int i = u0 + threadIdx.x; i < 0; i += T)")]),
    "no_cluster": ("at alpha: the cluster barriers and remote writes cut "
                   "(each block its own partials)", [
        (r"cgk::this_cluster\(\)\.sync\(\)", "__syncthreads()"),
        (r"cluster_arrive_relaxed\(\);", ";"), (r"cluster_wait\(\);", ";"),
        (r"cgk::this_cluster\(\)\.map_shared_rank\(part, r\)", "part")]),
    "cluster_launch": ("grid mode launched with a thread-block cluster "
                       "attribute of 1 block", [
        (r"nngp_quad_grid_kernel<kEtaSmem, VW>\s*<<<a\.G, kGridThreads, smem, "
         r"static_cast<cudaStream_t>\(stream\)>>>\(a\);\s*return cudaSuccess;",
         "return launch_cluster(nngp_quad_grid_kernel<kEtaSmem, VW>, a, "
         "static_cast<unsigned>(a.G), kGridThreads, 1, smem, stream);")]),
    "unroll_units2": ("both modes' unit loops unrolled by 2", [
        (r"(\n\s*)(for \(int i = threadIdx\.x; i < np; i \+= kGridThreads\))",
         r"\1#pragma unroll 2\1\2"),
        (r"(\n\s*)(for \(int i = u0 \+ threadIdx\.x; i < u1; i \+= T\))",
         r"\1#pragma unroll 2\1\2")]),
    "late_variance": ("grid mode: a unit's variance loaded after its "
                      "gathers, not with its lists", [
        (r"\n      const float id = __frcp_rn\(__ldg\(dg \+ i\)\);\n", "\n"),
        (r"(\n)(      float own\[kCols\];\n      gather\(i \* nf, own\);)",
         r"\1      const float id = __frcp_rn(__ldg(dg + i));\n\2")]),
    "slots5": ("five neighbour slots loaded together", [
        (r"constexpr int kSlots = 10;", "constexpr int kSlots = 5;")]),
    "threads256": ("blocks of 256 threads", [
        (r"constexpr int kGridThreads = 512;",
         "constexpr int kGridThreads = 256;")]),
    "scalar_gather": ("eta gathered a float at a time", [
        (r"const int vw = al && nf % 4 == 0 \? 4 : "
         r"al && nf % 2 == 0 \? 2 : 1;", "const int vw = al ? 1 : 1;")]),
}


def source_variants(torch, cs, K, tsp, cases, names, card):
    """Time each of ``SRC_VARIANTS`` (built from the source) against the
    shipped kernel, at the shipped launch shapes."""
    from probit_z_sweep import build_variants, use_library

    src = (K._CSRC / "nngp_quad.cu").read_text()
    libs = build_variants(src, {n: SRC_VARIANTS[n][1] for n in names},
                          "nngp_quad", "nngp_quad")
    for name in names:
        restore = use_library(K, libs[name][0], ("hmsc_nngp_quad_grid",
                                                 "hmsc_nngp_quad_at"))
        try:
            line = []
            for n, k, nf, lvd, alpha, eta, _, _ in cases:
                ms = cs.device_ms(torch, lambda: tsp.nngp_quad_grid(lvd, eta),
                                  "nngp_quad_grid_kernel")
                at = cs.device_ms(torch, lambda: tsp.nngp_quad_at(
                    lvd, alpha, eta), "nngp_quad_at_kernel")
                line.append(f"np {n} nf {nf}: grid {ms:.5f} ms, at alpha "
                            f"{at:.5f} ms")
        finally:
            restore()
        print(f"source {name} ({SRC_VARIANTS[name][0]}): " + "; ".join(line)
              + f" [{card}]", flush=True)


# an older source's C interface: grid mode (eta, lists (k, npp), grid
# (G, k, npp), variances (G, npp), out, C, np, nf, k, G, npp, S, units,
# eta_smem, stream), at alpha (eta, lists (np, k), grid (G, np, k),
# variances (G, np), alpha, out, C, np, nf, k, S, units, threads, stream)
_OLDER_GRID = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_OLDER_AT = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def older_version(torch, cs, K, tsp, cases, path, rounds, card):
    """Time an older source of the kernel (``path``: grid mode with the
    unit-last variances padded and a cluster size, at alpha reading the
    lists and grid unit first; see ``_OLDER_GRID``, ``_OLDER_AT``) through
    its own C interface, one block a grid point, in turns with the shipped
    kernel on the same inputs; each held against the plain version
    first."""
    from probit_z_sweep import build_variants, sass_counts

    libs = build_variants(pathlib.Path(path).read_text(), {"older": []},
                          "nngp_quad_older", "nngp_quad")
    lib, so = libs["older"]
    lib.hmsc_nngp_quad_grid.argtypes = _OLDER_GRID
    lib.hmsc_nngp_quad_at.argtypes = _OLDER_AT
    counts = sass_counts(so, "nngp_quad")
    if counts:
        print("older SASS instructions: " + ", ".join(
            f"{k} {v}" for k, v in counts.items()))

    def grid(lvd, eta):
        C, n, nf = eta.shape
        G, _, k = lvd.nn_coef.shape
        out = eta.new_empty((C, nf, G))
        K.check(lib.hmsc_nngp_quad_grid(
            eta.data_ptr(), lvd.nn_idx_u.data_ptr(), lvd.nn_coef_u.data_ptr(),
            lvd.nn_D.data_ptr(), out.data_ptr(), C, n, nf, k, G, n, 1, n,
            int(tsp.quad_geometry(C, n, nf)["eta_smem"]), K.stream_of(eta)),
            "nngp_quad (older)")
        return out

    def at(lvd, alpha, eta):
        C, n, nf = eta.shape
        q = tsp.quad_at_geometry(n)
        out = eta.new_empty((C, nf, 3))
        K.check(lib.hmsc_nngp_quad_at(
            eta.data_ptr(), lvd.nn_idx.data_ptr(), lvd.nn_coef.data_ptr(),
            lvd.nn_D.data_ptr(), alpha.data_ptr(), out.data_ptr(), C, n, nf,
            lvd.nn_idx.shape[1], q["S"], q["units"], q["threads"],
            K.stream_of(eta)), "nngp_quad (older)")
        return out

    for n, k, nf, lvd, alpha, eta, vp, ap_ in cases:
        e = max(((grid(lvd, eta) - vp).abs() / vp.abs()).max().item(),
                ((at(lvd, alpha, eta)[..., :2] - ap_[..., :2]).abs()
                 / ap_[..., :2].abs()).max().item())
        assert e <= 1e-5, f"older np {n} nf {nf}: {e}"
    for rnd in range(rounds):
        for label, fg, fa in (("shipped", tsp.nngp_quad_grid,
                               tsp.nngp_quad_at), ("older", grid, at)):
            line = []
            for n, k, nf, lvd, alpha, eta, _, _ in cases:
                ms = cs.device_ms(torch, lambda: fg(lvd, eta),
                                  "nngp_quad_grid_kernel")
                am = cs.device_ms(torch, lambda: fa(lvd, alpha, eta),
                                  "nngp_quad_at_kernel")
                line.append(f"np {n} nf {nf}: grid {ms:.5f} ms, at alpha "
                            f"{am:.5f} ms")
            print(f"round {rnd} {label} (same inputs, one process): "
                  + "; ".join(line) + f" [{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--source", default="",
                    help="comma-separated SRC_VARIANTS to time after the "
                         "launch shapes")
    ap.add_argument("--older", default="",
                    help="an older nngp_quad.cu to time in turns with the "
                         "shipped kernel")
    opts = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("nngp_quad_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hmsc_tpu_torch import kernels as K
    from hmsc_tpu_torch.ops import spatial as tsp
    from probit_z_sweep import sass_counts

    card = cs.card_line()
    print(card)
    dev = torch.device("cuda", 0)
    K.library()
    so = K._build()
    counts = sass_counts(so, "nngp_quad")
    if counts:
        print("SASS instructions: " + ", ".join(f"{k} {v}"
                                                for k, v in counts.items()))
    shapes = [(n, k, side, cs.B8_NF) for n, k, side in cs.B8B_SHAPES] + [
        (1000, 10, 10.0, 8)]
    cases = []
    for n, k, side, nf in shapes:
        lvd = cs.nngp_level(torch, dev, n, k, side, seed=n)
        g = torch.Generator(device=dev).manual_seed(n + 2)
        alpha = torch.randint(0, cs.B8_G, (cs.B8_C, nf), generator=g,
                              device=dev, dtype=torch.int32)
        eta = torch.randn((cs.B8_C, n, nf), generator=g, device=dev)
        vp = tsp._nngp_quad_grid_plain(lvd, eta)
        ap_ = tsp._nngp_quad_at_plain(lvd, alpha, eta)
        cases.append((n, k, nf, lvd, alpha, eta, vp, ap_))
    grid0 = tsp.quad_geometry
    consts0 = {c: getattr(tsp, c) for c in ("_CLUSTER_MAX", "_QUAD_SMEM")}
    names = opts.variants.split(",")
    for rnd in range(opts.rounds):
        for name in names:
            what, consts, gov = VARIANTS[name]
            for c, v in consts.items():
                setattr(tsp, c, v)
            tsp.quad_geometry = (grid0 if gov is None else
                                 lambda C, n, nf, f=gov: f(
                                     grid0(C, n, nf)))
            try:
                line = []
                for n, k, nf, lvd, alpha, eta, vp, ap_ in cases:
                    vk = tsp.nngp_quad_grid(lvd, eta)
                    ak = tsp.nngp_quad_at(lvd, alpha, eta)
                    e = max(((vk - vp).abs() / vp.abs()).max().item(),
                            ((ak[..., :2] - ap_[..., :2]).abs()
                             / ap_[..., :2].abs()).max().item())
                    assert e <= 1e-5, f"{name} np {n} nf {nf}: {e}"
                    assert torch.equal(vk, tsp.nngp_quad_grid(lvd, eta))
                    assert torch.equal(ak, tsp.nngp_quad_at(lvd, alpha, eta))
                    ms = cs.device_ms(torch, lambda: tsp.nngp_quad_grid(
                        lvd, eta), "nngp_quad_grid_kernel")
                    at = cs.device_ms(torch, lambda: tsp.nngp_quad_at(
                        lvd, alpha, eta), "nngp_quad_at_kernel")
                    q = tsp.quad_geometry(cs.B8_C, n, nf)
                    qa = tsp.quad_at_geometry(n)
                    line.append(f"np {n} nf {nf}: grid {ms:.5f} ms "
                                f"(eta staged {q['eta_smem']}), at alpha "
                                f"{at:.5f} ms (S {qa['S']}, {qa['threads']} "
                                f"threads)")
            finally:
                tsp.quad_geometry = grid0
                for c, v in consts0.items():
                    setattr(tsp, c, v)
            print(f"round {rnd} {name} ({what}): " + "; ".join(line)
                  + f" [{card}]", flush=True)
    if opts.source:
        source_variants(torch, cs, K, tsp, cases, opts.source.split(","),
                        card)
    if opts.older:
        older_version(torch, cs, K, tsp, cases, opts.older, opts.rounds, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
