#!/usr/bin/env python3
"""Where kernel B9b's time goes (``hmsc_tpu_torch/csrc/serve_conditional.cu``),
on one CUDA card.

    python3 scripts/serve_conditional_sweep.py [--first FILE] [--rounds N]
                                               [--variants a,b]

Compiles copies of the kernel's source (with ``truncnorm.cuh``, the
truncated normal it shares with B1, written in) into
``build/conditional_variants/``, each with one part cut out or changed, prints each copy's registers and
spills, and times each (torch.profiler: the refinement kernel and the
moments' combine) at the headline posterior's shapes (chip_smoke.py's
``serve_inputs``: 800 draws, nc 2, nf 8, 1000 species, 500 observed) at
mcmc_step 3, expected moments, B 64 (and B 8, B 1 for the shipped
geometries).  The copies that compute the same function are held against
the plain version (1e-5); the diagnostic ones (a part cut out) are only
timed.  ``--rounds N`` times the list (``--variants``, all by default) N
times in turn, so that two copies are compared within one call.

Beside the times it prints the issue-rate floor of the Z refresh: the
static instruction count of the refresh loop's body in the SASS of a
marked copy (``cuobjdump -sass``; a ``nanosleep`` marks the loop) times
the refreshed cells, over the card's issue rate (4 warp instructions a
clock on each SM at the maximum SM clock), for the shipped source and for
the copy with the library's Phi and Phi^-1 (``library_tn``).

``--first FILE`` times instead the kernel's first version (a block of 256
threads a (query row, draw chunk), threads over species, Lambda read from
L2 in every pass; its source as git holds it before the warp-per-row
redesign, e.g. ``git show <commit>:hmsc_tpu_torch/csrc/serve_conditional.cu
> FILE``), called through its own C interface, with copies that have no
barriers, no Philox draws, or Lambda read from shared memory.

Each line carries the card's name and power limit.  It measures; it
changes nothing in the package.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

CHEAP_BITS = """
// a stand-in for Philox: a few integer operations
__device__ __forceinline__ uint4 cheap_bits(uint4 c, uint2 k) {
  return make_uint4(c.x ^ k.x, c.y * 2654435761u, (c.z + c.w) ^ k.y,
                    c.x * 747796405u + c.w);
}
"""

_LAM_LOAD = (r"hmsc::load_draw\(lam \+ \(static_cast<long long>\(\s*nn\)"
             r"\s*\*\s*nf \+ f\) \* ns \+ j\)")

# the first version: name -> (what it is, [(regex, replacement)])
FIRST_VARIANTS = {
    "first": ("the first version as it was", []),
    "first_no_barriers": ("diagnostic: every __syncthreads cut", [
        (r"__syncthreads\(\);", "")]),
    "first_no_philox": ("diagnostic: Philox replaced by a few integer "
                        "operations", [
        (r"namespace \{\n", "namespace {\n" + CHEAP_BITS),
        (r"hmsc::philox4x32_10\(", "cheap_bits(")]),
    "first_lam_smem": ("diagnostic: Lambda read from shared memory (level "
                       "0 of the chunk's first draw, staged once)", [
        (r"const int smem = 5 \* ns", "const int smem = (5 + NFM) * ns"),
        (r"float\* m2_s = dyn \+ 4 \* ns;",
         "float* m2_s = dyn + 4 * ns;\n  float* lamf_s = dyn + 5 * ns;"),
        (r"for \(int j = tid; j < ns; j \+= kThreads\) mean_s\[j\] = "
         r"m2_s\[j\] = 0.0f;",
         "for (int j = tid; j < ns; j += kThreads) mean_s[j] = m2_s[j] = "
         "0.0f;\n  for (int i = tid; i < NFM * ns; i += kThreads) "
         "lamf_s[i] = hmsc::load_draw(static_cast<const T*>(lv.lam[0]) + "
         "static_cast<long long>(d0) * lv.nf[0] * ns + "
         "min(i, lv.nf[0] * ns - 1));"),
        (_LAM_LOAD, "lamf_s[f * ns + j]")]),
}
# the marker of the first version's refresh loop (SASS only, not timed)
FIRST_MARK = [(r"for \(int j = tid; j < ns; j \+= kThreads\)\n"
               r"(\s*)z_s\[j\] = z_draw\(j, s \+ 1\);",
               r"for (int j = tid; j < ns; j += kThreads) {\n\1"
               r"__nanosleep(1);\n\1z_s[j] = z_draw(j, s + 1);\n\1}")]

# the shipped kernel: name -> (what it is, [(regex, replacement)], computes
# the same function, ops.serve constants the copy runs under)
VARIANTS = {
    "shipped": ("the kernel as built", [], True, {}),
    "library_tn": ("the truncated normal's Phi and Phi^-1 as normcdff and "
                   "normcdfinvf, as before B1's redesign", [
                       (r"u \* upper_prob\(t\)", "u * normcdff(-t)"),
                       (r"x = neg_ndtri\(p\);", "x = -normcdfinvf(p);")],
                   True, {}),
    "stages1": ("one stage of draws (no copy in flight while a draw "
                "computes)", [], True, {"_COND_MAX_STAGES": 1}),
    "unstaged": ("no staging: Lambda, Beta and sigma read from L2", [],
                 True, {"_COND_MAX_STAGES": 0}),
    "target_2x": ("twice the draw chunks (two waves)", [], True,
                  {"_COND_WAVES": 2}),
    "w8": ("blocks of 8 warps", [], True, {"_COND_WARPS": 8}),
    "unroll2": ("the refresh-and-F pass unrolled by 2", [
        (r"(\n\s*)(for \(int o = lane; o < nobs; o \+= 32\) \{   "
         r"// refresh-and-F pass)", r"\1#pragma unroll 2\1\2")], True, {}),
    "no_philox": ("diagnostic: Philox replaced by a few integer "
                  "operations", [
        (r"namespace \{\n", "namespace {\n" + CHEAP_BITS),
        (r"hmsc::philox4x32_10\(", "cheap_bits(")], False, {}),
    "no_truncnorm": ("diagnostic: the truncated normal cut (z = E + u)", [
        (r"return hmsc::probit_z_draw\(E, sd, \(ent & kYcUp\) != 0u, u\);",
         "return E + u;")], False, {}),
    "no_gram": ("diagnostic: no gram pass (P = I)", [
        (r"(const float w = isig\(j\) \* \(\(ent & kMaskOther\) \? "
         r"mk_b\[j\] : 1\.0f\);)", r"const float w = 0.0f;\n          "
         r"continue;")], False, {}),
    "no_solve": ("diagnostic: no Cholesky solves (rows = F + eps)", [
        (r"warp_solve<NFM>\(chol_s \+ r \* NFM \* NFM, nf,\s*lane < nf "
         r"\? F : 0\.0f, eps\)", "F + eps")], False, {}),
    "no_first_pass": ("diagnostic: E not formed (E = 0)", [
        (r"(for \(int j0 = lane; j0 < )ns(; j0 \+= 128\) \{\n\s*int "
         r"jj\[4\];)", r"\g<1>0\2")], False, {}),
    "no_last_pass": ("diagnostic: no last pass (no link, no moments)", [
        (r"(for \(int j0 = lane; j0 < )ns(; j0 \+= 128\) \{\n\s*float "
         r"mo\[4\])", r"\g<1>0\2")], False, {}),
    "no_refresh": ("diagnostic: no Z refresh (z = E)", [
        (r"z = refresh\(ent, E, t\);", "z = E;")],
        False, {}),
}
SHIPPED_MARK = [(r"(// refresh-and-F pass\n)(\s*)",
                 r"\1\2__nanosleep(1);\n\2")]

_FIRST_TYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int]
                + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                + [ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_void_p])


def _apply(src, subs):
    for pat, rep in subs:
        src, k = re.subn(pat, rep, src)
        assert k > 0, pat
    return src


def build(src, variants, tag):
    """Compile each (name, substitutions) copy of ``src`` into a shared
    library, started together; print registers and spills.  Returns
    {name: (ctypes library, path)}."""
    from hmsc_tpu_torch.kernels import _CSRC, _FLAGS, _nvcc

    out = ROOT / "build" / "conditional_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, subs in variants.items():
        cu = out / f"{tag}_{name}.cu"
        cu.write_text(_apply(src, subs))
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
                entry = "serve_conditional" in ln and "If" in ln
            elif entry and ("Used" in ln or "spill" in ln):
                regs.append(ln.split(":", 1)[-1].strip())
        print(f"{name}: float32 kernels: {'; '.join(regs[:6])}", flush=True)
        libs[name] = (ctypes.CDLL(str(so)), so)
    return libs


def refresh_loop_instructions(so_path):
    """Static instruction count of the marked refresh loop's body (the
    innermost loop holding the NANOSLEEP marker, the marker left out) in
    each float32 kernel of the library: {kernel: count}, or None without
    cuobjdump."""
    import chip_smoke as cs

    tool = cs.cuobjdump()
    if tool is None:
        return None
    r = subprocess.run([tool, "-sass", str(so_path)], capture_output=True,
                       text=True, timeout=600)
    if r.returncode != 0:
        return None
    counts, name, ins, at = {}, None, [], {}

    def close():
        if name is None:
            return
        loops = []
        for i, (op, text) in enumerate(ins):
            m = re.search(r"BRA\S*\s+(?:`\()?(0x[0-9a-f]+)", text)
            if op.startswith("BRA") and m and at.get(int(m.group(1), 16),
                                                     i + 1) <= i:
                loops.append((at[int(m.group(1), 16)], i))
        marks = [i for i, (op, _) in enumerate(ins) if op.startswith(
            "NANOSLEEP")]
        best = None
        for a, b in loops:
            if any(a <= k <= b for k in marks) and (
                    best is None or b - a < best[1] - best[0]):
                best = (a, b)
        if best is not None:
            counts[name] = best[1] - best[0] + 1 - 1
    for ln in r.stdout.splitlines():
        if "Function :" in ln:
            close()
            fn = ln.split("Function :")[1].strip()
            name = fn if "serve_conditional" in fn and "If" in fn else None
            ins, at = [], {}
            continue
        if name is None:
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if not m:
            continue
        at[int(m.group(1), 16)] = len(ins)
        words = m.group(2).split()
        ins.append((words[1] if words[0].startswith("@") and len(words) > 1
                    else words[0], m.group(2)))
    close()
    return counts


def issue_floor_ms(torch, per_cell, cells):
    import chip_smoke as cs

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return per_cell * cells / (sms * 4 * 32 * cs.sm_clock_hz()) * 1e3


def call_first(lib, torch, tserve, X, uidx, Yc, mask, rest, steps, expected,
               seed=3, offset=4, target=4224):
    """The first version's C interface as its wrapper called it: grid (B,
    chunks), chunks from a target of ``target`` blocks."""
    from hmsc_tpu_torch import kernels as K

    Beta, sigma, lams, etas, fam, ym, ys = rest
    n, nc, ns = Beta.shape
    B = X.shape[0]
    S = max(1, min(n, -(-target // max(B, 1))))
    D = -(-n // S)
    S = -(-n // D)
    nf_max = max(int(lam.shape[1]) for lam in lams)
    nfm = next(m for m in (4, 8, 16) if m >= nf_max)
    f32 = dict(device=Beta.device, dtype=torch.float32)
    mean, sd = torch.empty((B, ns), **f32), torch.empty((B, ns), **f32)
    pmean, pm2 = (torch.empty((S, B, ns), **f32) for _ in range(2))
    lv, nr = tserve._level_args(lams, etas)
    code = lib.hmsc_serve_conditional(
        X.data_ptr(), uidx.data_ptr(), Yc.data_ptr(), mask.data_ptr(),
        Beta.data_ptr(), sigma.data_ptr(),
        *(ctypes.addressof(a) for a in lv), nr, fam.data_ptr(),
        ym.data_ptr(), ys.data_ptr(), None, None, None, None,
        pmean.data_ptr(), pm2.data_ptr(), mean.data_ptr(), sd.data_ptr(), n,
        B, ns, nc, steps, nfm, D, S, int(Beta.dtype == torch.bfloat16),
        int(expected), seed, offset, K.stream_of(Beta))
    K.check(code, "serve_conditional (first version)")
    return mean, sd


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--first", default=None)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("serve_conditional_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hmsc_tpu_torch import kernels as K
    from hmsc_tpu_torch.ops import serve as tserve

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    main_lib = K.library()
    steps, n, ns, observed = 3, cs.SERVE["n"], cs.SERVE["ns"], 500
    names = ("serve_conditional_kernel", "combine_moments_kernel")
    inputs = {}
    for B in (64, 8, 1):
        args = cs.serve_inputs(torch, dev, B, seed=70 + B)
        Yc, mask = cs.conditional_query(torch, dev, args, seed=71,
                                        observed=observed)
        inputs[B] = (args[0], args[1], Yc, mask, args[2:])

    if opts.first:
        src = pathlib.Path(opts.first).read_text()
        libs = build(src, {k: v[1] for k, v in FIRST_VARIANTS.items()},
                     "first")
        marked = build(src, {"first_marked": FIRST_MARK}, "first")
        X, uidx, Yc, mask, rest = inputs[64]
        for lib, _ in libs.values():
            lib.hmsc_serve_conditional.argtypes = _FIRST_TYPES
            lib.hmsc_serve_conditional.restype = ctypes.c_int
        for rnd in range(opts.rounds):
            for name, (what, _) in FIRST_VARIANTS.items():
                lib = libs[name][0]
                ms = cs._kernel_ms(torch, lambda: call_first(
                    lib, torch, tserve, X, uidx, Yc, mask, rest, steps,
                    True), names)
                print(f"round {rnd}: {name} ({what}): B 64, mcmc_step "
                      f"{steps}, {observed} of {ns} observed, expected: "
                      f"{ms:.4f} ms [{card}]", flush=True)
        per = refresh_loop_instructions(marked["first_marked"][1])
        if per:
            k = next((k for k in per if "Li8E" in k), min(per, key=len))
            cells = n * 64 * observed * (steps + 1)
            print(f"first version SASS: {per[k]} instructions in the refresh "
                  f"loop's body ({k[:60]}...); {cells} refreshed cells "
                  f"(mcmc_step + 1 refreshes) -> issue-rate floor of the "
                  f"refreshes {issue_floor_ms(torch, per[k], cells):.4f} ms "
                  f"[{card}]")
        else:
            print("first version SASS: no cuobjdump or no marked loop")
        return 0

    from probit_z_sweep import inline_header

    src = inline_header(K, "serve_conditional.cu", "truncnorm.cuh")
    chosen = {k: VARIANTS[k] for k in opts.variants.split(",")}
    libs = build(src, {k: v[1] for k, v in chosen.items()}, "now")
    marked = build(src, {"marked": SHIPPED_MARK,
                         "marked_library_tn": VARIANTS["library_tn"][1]
                         + SHIPPED_MARK}, "now")
    argtypes = main_lib.hmsc_serve_conditional.argtypes
    plain = {}
    for B, (X, uidx, Yc, mask, rest) in inputs.items():
        g = torch.Generator(device=dev).manual_seed(72)
        nf = cs.SERVE["nf"]
        noise = {"eps_z": torch.randn((n, steps + 1, B, ns), generator=g,
                                      device=dev),
                 "u_z": torch.rand((n, steps + 1, B, ns), generator=g,
                                   device=dev).clamp_min_(1e-38),
                 "eps_rows": torch.randn((n, steps, B, nf), generator=g,
                                         device=dev)}
        plain[B] = (noise, tserve._serve_conditional_plain(
            X, uidx, Yc, mask, *rest, steps, True, noise, None))
    try:
        for rnd in range(opts.rounds):
            for name, (what, _, same, consts) in chosen.items():
                lib = libs[name][0]
                lib.hmsc_serve_conditional.argtypes = argtypes
                lib.hmsc_serve_conditional.restype = ctypes.c_int
                K._lib = lib
                saved = {k: getattr(tserve, k) for k in consts}
                for k, v in consts.items():
                    setattr(tserve, k, v)
                row = []
                for B, (X, uidx, Yc, mask, rest) in inputs.items():
                    if B != 64 and not consts and name != "shipped":
                        continue
                    geo = tserve.conditional_geometry(
                        n, B, ns, cs.SERVE["nc"], [cs.SERVE["nf"]])
                    if same and rnd == 0:
                        noise, (mp, sp) = plain[B]
                        mk, sk = tserve.serve_conditional(
                            X, uidx, Yc, mask, *rest, mcmc_step=steps,
                            expected=True, noise=noise)
                        err = max((mk - mp).abs().max().item(),
                                  (sk - sp).abs().max().item())
                        assert err <= 1e-5, (name, B, err)
                    ms = cs._kernel_ms(torch, lambda: tserve.serve_conditional(
                        X, uidx, Yc, mask, *rest, mcmc_step=steps,
                        expected=True, seed=3, offset=4), names)
                    row.append(f"B {B} ({geo.rows} rows x {geo.slots} draw "
                               f"slots, {geo.warps} warps, {geo.stages} "
                               f"stages, {geo.S} chunks of {geo.D}): "
                               f"{ms:.4f} ms")
                for k, v in saved.items():
                    setattr(tserve, k, v)
                print(f"round {rnd}: {name} ({what}): mcmc_step {steps}, "
                      f"{observed} of {ns} observed, expected: "
                      + "; ".join(row) + f" [{card}]", flush=True)
    finally:
        K._lib = main_lib
    for label in ("marked", "marked_library_tn"):
        per = refresh_loop_instructions(marked[label][1])
        if not per:
            print("SASS: no cuobjdump or no marked loop")
            break
        k = next((k for k in per if "Li8E" in k), min(per, key=len))
        cells = n * 64 * observed * steps
        print(f"SASS ({label}): {per[k]} instructions in the refresh loop's "
              f"body ({k[:60]}...); {cells} refreshed cells (mcmc_step "
              f"refreshes) -> issue-rate floor of the refreshes "
              f"{issue_floor_ms(torch, per[k], cells):.4f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
