#!/usr/bin/env python3
"""Where kernel B1's time goes (``hmsc_tpu_torch/csrc/probit_z.cu``, both
operand forms), on one CUDA card.

    python3 scripts/probit_z_sweep.py [--variants a,b] [--rounds N]
                                      [--sass-out FILE]

Compiles copies of the kernel's source (with ``truncnorm.cuh``, the draw
it shares with B9b, written in) into ``build/kernel_variants/``, each with
one part changed or cut out, prints each copy's registers and
spills and each kernel's static SASS instruction count (``cuobjdump
-sass``; the E-reading kernel has no loop, so its count over its 16 cells
is about what a cell issues), and times each copy's E-reading and fused
forms (torch.profiler, the kernel alone) at the headline shape and at
config 3b's (``chip_smoke.B1_SHAPES``), with the uniforms drawn in the
kernel.  The copies that compute the same function are held against the
plain version (1e-4 sd on injected uniforms); the diagnostic ones (a part
cut out) are only timed.  ``--rounds N`` times the list N times in turn,
so that two copies are compared within one call; ``--sass-out FILE``
writes the first copy's whole SASS to FILE.  Each line carries the
card's name and power limit.  It measures; it changes nothing in the
package.
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

CHEAP_BITS = """
// a stand-in for Philox: a few integer operations
__device__ __forceinline__ uint4 cheap_bits(uint4 c, uint2 k) {
  return make_uint4(c.x ^ k.x, c.y * 2654435761u, (c.z + c.w) ^ k.y,
                    c.x * 747796405u + c.w);
}
"""

# name -> (what, [(regex, replacement)], computes the same function)
VARIANTS = {
    "shipped": ("the kernel as built", [], True),
    "library_math": ("Phi and Phi^-1 as normcdff and normcdfinvf, as the "
                     "first version", [
        (r"u \* upper_prob\(t\)", "u * normcdff(-t)"),
        (r"x = neg_ndtri\(p\);", "x = -normcdfinvf(p);")], True),
    "library_exp_log": ("exp2, log2 and rsqrt as the library's exp2f, "
                        "__log2f and rsqrtf (with their subnormal fix-ups)",
                        [(r"ex2_ftz\((1\.4426950408889634f)", r"exp2f(\1"),
                         (r"lg2_ftz\(fminf", "__log2f(fminf"),
                         (r"rsqrt_ftz\(w\)", "rsqrtf(w)")], True),
    "device_keys": ("Philox's round keys formed in the kernel", [
        (r"a\.keys\);", "a.keys.k[0]);")], True),
    "library_div": ("the reciprocals as __fdividef (with its range "
                    "fix-ups)", [
        (r"rcp_ftz\(fmaf\(0\.5f, z, 1\.0f\)\)",
         "__fdividef(1.0f, fmaf(0.5f, z, 1.0f))"),
        (r"return num \* rcp_ftz\(central \? nb : nd\);",
         "return __fdividef(num, central ? nb : nd);")], True),
    "rows1": ("a row a thread (4 cells)", [
        (r"constexpr int kRows = 4;", "constexpr int kRows = 1;")], True),
    "rows8": ("eight rows a thread (32 cells)", [
        (r"constexpr int kRows = 4;", "constexpr int kRows = 8;")], True),
    "no_philox": ("diagnostic: Philox replaced by a few integer "
                  "operations", [
        (r"namespace \{\n", "namespace {\n" + CHEAP_BITS),
        (r"hmsc::philox4x32_10\(", "cheap_bits(")], False),
    "no_phi": ("diagnostic: P(W > t) cut (1/2)", [
        (r"u \* upper_prob\(t\)", "u * 0.5f")], False),
    "no_ndtri": ("diagnostic: Phi^-1 cut (x = p)", [
        (r"x = neg_ndtri\(p\);", "x = p;")], False),
    "no_stage": ("diagnostic: the fused form's staging cut (its operands "
                 "left unset)", [
        (r"if \(kFused\) \{\n    // a thread a row",
         "if (false) {\n    // a thread a row")],
        False),
}


def inline_header(K, source, header):
    """The kernel source ``source`` with ``header`` written in place of its
    include, so a copy's substitutions can change either."""
    head = (K._CSRC / header).read_text().replace("#pragma once", "")
    return (K._CSRC / source).read_text().replace(f'#include "{header}"',
                                                  head)


def _apply(src, subs):
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        assert n > 0, pat
    return src


def build_variants(src, variants, tag, match):
    """Compile each ``{name: substitutions}`` copy of ``src`` into a shared
    library (one nvcc each, started together) and print the registers and
    spills of the kernels whose name holds ``match``.  Returns {name: (ctypes
    library, path)}."""
    from hmsc_tpu_torch.kernels import _CSRC, _FLAGS, _nvcc

    out = ROOT / "build" / "kernel_variants"
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
                entry = ln.split("'")[1] if "'" in ln else ln
            elif entry and match in entry and ("Used" in ln or "spill" in ln):
                regs.append(f"{_short(entry)}: "
                            f"{ln.split(':', 1)[-1].strip()}")
        print(f"{name}: {'; '.join(regs)}", flush=True)
        libs[name] = (ctypes.CDLL(str(so)), so)
    return libs


def _short(mangled):
    """A kernel's name and template arguments from its mangled name."""
    m = re.search(r"(\d+)([a-z_]+_kernel)(I.*?E)?E", mangled)
    return f"{m.group(2)}{m.group(3) or ''}" if m else mangled


def sass_counts(so_path, match):
    """Static SASS instruction count of each kernel of the library whose
    name holds ``match`` (NOPs left out): {kernel: count}, or None without
    cuobjdump."""
    import chip_smoke as cs

    tool = cs.cuobjdump()
    if tool is None:
        return None
    r = subprocess.run([tool, "-sass", str(so_path)], capture_output=True,
                       text=True, timeout=600)
    if r.returncode != 0:
        return None
    counts, fn = {}, None
    for ln in r.stdout.splitlines():
        if "Function :" in ln:
            fn = _short(ln.split("Function :")[1].strip())
            if match not in fn:
                fn = None
            else:
                counts[fn] = 0
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if fn and m:
            words = m.group(2).split()
            op = words[1] if words[0].startswith("@") and len(words) > 1 \
                else words[0]
            counts[fn] += not op.startswith("NOP")
    return counts


def use_library(K, lib, names):
    """Point ``kernels.library`` at ``lib`` with the argument types of the
    built library's functions ``names``; returns the restore callable."""
    base = K.library()
    for n in names:
        fn = getattr(lib, n)
        fn.argtypes = getattr(base, n).argtypes
        fn.restype = ctypes.c_int
    saved = K._lib
    K._lib = lib
    return lambda: setattr(K, "_lib", saved)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--sass-out", default="",
                    help="write the first variant's cuobjdump -sass here")
    opts = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probit_z_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hmsc_tpu_torch import kernels as K
    from hmsc_tpu_torch.ops import rand as trand

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    dev = torch.device("cuda", 0)
    names = opts.variants.split(",")
    src = inline_header(K, "probit_z.cu", "truncnorm.cuh")
    libs = build_variants(src, {n: VARIANTS[n][1] for n in names}, "probit_z",
                          "probit_z")
    if opts.sass_out and cs.cuobjdump():
        pathlib.Path(opts.sass_out).write_text(subprocess.run(
            [cs.cuobjdump(), "-sass", str(libs[names[0]][1])],
            capture_output=True, text=True, timeout=600).stdout)
    for n in names:
        counts = sass_counts(libs[n][1], "probit_z")
        if counts:
            print(f"{n} SASS instructions: " + ", ".join(
                f"{k} {v} ({v / 16:.1f} a cell at 4 rows)"
                for k, v in counts.items()))
    inputs = {label: cs.b1_inputs(torch, dev, sh["C"], sh["ny"], sh["ns"],
                                  sh["nc"], sh["npr"], sh["nf"],
                                  seed=sh["ny"] + sh["ns"])
              for label, sh in cs.B1_SHAPES}
    fns = ("hmsc_probit_z", "hmsc_probit_z_fused")
    for rnd in range(opts.rounds):
        for n in names:
            what, _, same = VARIANTS[n]
            restore = use_library(K, libs[n][0], fns)
            try:
                line = []
                for label, (X, Beta, level, E, std, Y, u) in inputs.items():
                    if same:
                        sd = std[:, None, :]
                        zp = trand._truncated_normal_onesided_plain(E, std,
                                                                    Y, u)
                        zk = trand.truncated_normal_onesided(E, std, Y, u=u)
                        zf = trand.probit_z_fused(X, Beta, std, Y, u=u,
                                                  level=level)
                        err = max(((zk - zp).abs() / sd).max().item(),
                                  ((zf - zp).abs() / sd).max().item())
                        assert err <= 1e-4, f"{n} {label}: {err} sd"
                    rng = trand.Rng(5, dev)
                    ms_e = cs.device_ms(torch, lambda: (
                        trand.truncated_normal_onesided(E, std, Y, rng)),
                        "probit_z_kernel")
                    ms_f = cs.device_ms(torch, lambda: trand.probit_z_fused(
                        X, Beta, std, Y, rng, level=level), "probit_z_kernel")
                    line.append(f"{label} E-reading {ms_e:.5f} ms, fused "
                                f"{ms_f:.5f} ms")
            finally:
                restore()
            print(f"round {rnd} {n} ({what}): " + "; ".join(line)
                  + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
