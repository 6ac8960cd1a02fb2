"""Minimal model-formula support: R-style ``~ ...`` formulas -> design matrices.

The reference builds design matrices with R's ``model.matrix`` (reference
``R/Hmsc.R:202,214``).  We support the subset of Wilkinson notation that the
reference's vignettes and tests exercise:

- ``~ x1 + x2``           main effects (implicit intercept)
- ``~ x1 * x2``           main effects + interaction
- ``~ x1:x2``             interaction only
- ``~ . ``                all columns of the data frame
- ``~ x - 1`` / ``~ x + 0``   drop the intercept
- ``poly(x, n)``          raw orthogonal polynomial columns (numpy Legendre-free
                          QR orthogonalisation, like R's ``poly``)
- arbitrary numpy expressions via ``I(...)``, ``log(x)``, ``exp(x)`` etc.
- categorical expansion with treatment (drop-first) coding for string /
  categorical / boolean columns, matching R factor handling.

This is host-side, numpy-only code; it runs once at model construction.
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["design_matrix", "Formula", "align_factor_levels"]

_SAFE_FUNCS = {
    "log": np.log, "log2": np.log2, "log10": np.log10, "log1p": np.log1p,
    "exp": np.exp, "sqrt": np.sqrt, "abs": np.abs, "sin": np.sin,
    "cos": np.cos, "tan": np.tan, "scale": lambda a: (np.asarray(a, float) - np.mean(a)) / np.std(a, ddof=1),
}


def _tokenize_terms(rhs: str) -> tuple[list[str], bool]:
    """Split the RHS on top-level ``+``/``-`` into term strings.

    Returns (terms, intercept).  ``- 1`` / ``+ 0`` toggle the intercept off.
    """
    terms: list[str] = []
    intercept = True
    depth = 0
    cur = ""
    sign = "+"
    for ch in rhs + "+":
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch in "+-" and depth == 0:
            tok = cur.strip()
            if tok:
                if tok in ("1", "0"):
                    if (sign == "-" and tok == "1") or (sign == "+" and tok == "0"):
                        intercept = False
                    elif sign == "+" and tok == "1":
                        intercept = True
                elif sign == "-":
                    terms = [t for t in terms if t != tok]
                else:
                    terms.append(tok)
            cur = ""
            sign = ch
        else:
            cur += ch
    return terms, intercept


def _expand_star(term: str) -> list[str]:
    """``a*b`` -> ``a, b, a:b`` (only top-level ``*``)."""
    depth = 0
    parts = []
    cur = ""
    for ch in term:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == "*" and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    parts.append(cur)
    parts = [p.strip() for p in parts if p.strip()]
    if len(parts) == 1:
        return parts
    out = list(parts)
    # all pairwise+higher interactions, in R's order (mains, then 2-way, ...)
    from itertools import combinations

    for k in range(2, len(parts) + 1):
        for combo in combinations(parts, k):
            out.append(":".join(combo))
    return out


def _split_interaction(term: str) -> list[str]:
    depth = 0
    parts = []
    cur = ""
    for ch in term:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == ":" and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    parts.append(cur)
    return [p.strip() for p in parts if p.strip()]


def _poly(x, degree: int) -> np.ndarray:
    """Orthogonal polynomial basis like R's ``poly(x, degree)``."""
    x = np.asarray(x, dtype=float)
    xbar = x.mean()
    M = np.vander(x - xbar, degree + 1, increasing=True)
    Q, R = np.linalg.qr(M)
    Z = Q[:, 1:] * np.sign(np.diag(R)[1:])
    norms = np.sqrt((Z**2).sum(axis=0))
    return Z / norms


def _eval_factor(expr: str, df) -> tuple[list[str], list[np.ndarray], bool]:
    """Evaluate a single factor expression.

    Returns (column names, columns, is_categorical). Categorical factors return
    the *full* one-hot set; contrast dropping happens at term assembly.
    """
    expr = expr.strip()
    m = re.fullmatch(r"poly\(\s*([A-Za-z_.][\w.]*)\s*,\s*(\d+)\s*\)", expr)
    if m:
        name, deg = m.group(1), int(m.group(2))
        Z = _poly(np.asarray(df[name]), deg)
        return ([f"poly({name},{deg}){i+1}" for i in range(deg)],
                [Z[:, i] for i in range(deg)], False)
    if re.fullmatch(r"[A-Za-z_.][\w.]*", expr):  # bare column name
        col = df[expr]
        vals = np.asarray(col)
        if vals.dtype.kind in "OUSb" or str(getattr(col, "dtype", "")) == "category":
            cats = getattr(getattr(col, "cat", None), "categories", None)
            if cats is None:
                cats = sorted({str(v) for v in vals})
            else:
                cats = list(cats)
            cols = [np.asarray([str(v) == str(c) for v in vals], dtype=float) for c in cats]
            return ([f"{expr}{c}" for c in cats], cols, True)
        return ([expr], [vals.astype(float)], False)
    # I(...) wrapper or a general expression
    inner = expr
    if expr.startswith("I(") and expr.endswith(")"):
        inner = expr[2:-1]
    ns = dict(_SAFE_FUNCS)
    for c in df.columns if hasattr(df, "columns") else []:
        ns[str(c)] = np.asarray(df[c])
    val = eval(inner, {"__builtins__": {}}, ns)  # noqa: S307 - restricted namespace
    return ([expr], [np.asarray(val, dtype=float)], False)


class Formula:
    """Parsed model formula; call :meth:`design` to build the matrix."""

    def __init__(self, formula: str):
        formula = formula.strip()
        if formula.startswith("~"):
            formula = formula[1:]
        self.rhs = formula.strip()

    def design(self, df) -> tuple[np.ndarray, list[str]]:
        rhs = self.rhs
        if rhs == ".":
            rhs = " + ".join(str(c) for c in df.columns)
        raw_terms, intercept = _tokenize_terms(rhs)
        terms: list[str] = []
        for t in raw_terms:
            for e in _expand_star(t):
                if e not in terms:
                    terms.append(e)

        names: list[str] = []
        cols: list[np.ndarray] = []
        if intercept:
            n = len(df)
            names.append("(Intercept)")
            cols.append(np.ones(n))
        drop_contrast = intercept  # without an intercept the first categorical
        for term in terms:         # main effect keeps all its levels (R rule)
            factors = [_eval_factor(f, df) for f in _split_interaction(term)]
            pieces = []
            for fnames, fcols, is_cat in factors:
                if is_cat:
                    if not drop_contrast and len(factors) == 1:
                        drop_contrast = True
                    else:
                        fnames, fcols = fnames[1:], fcols[1:]
                pieces.append((fnames, fcols))
            # cross the pieces
            cur = [("", np.ones(len(df)))]
            for fnames, fcols in pieces:
                cur = [((f"{n0}:{n1}" if n0 else n1), c0 * c1)
                       for (n0, c0) in cur for (n1, c1) in zip(fnames, fcols)]
            for n1, c1 in cur:
                if n1 not in names:
                    names.append(n1)
                    cols.append(c1)
        Xm = np.column_stack(cols) if cols else np.empty((len(df), 0))
        return Xm.astype(float), names


def design_matrix(formula: str, df) -> tuple[np.ndarray, list[str]]:
    """R ``model.matrix(formula, df)`` equivalent (subset; see module doc)."""
    return Formula(formula).design(df)


def align_factor_levels(df, ref_df):
    """``df`` with every categorical column coerced to the *training*
    frame's level set (R's ``xlev=`` argument to ``model.matrix``).

    Prediction frames routinely hold a SUBSET of the fitted levels — a
    gradient frame sets a non-focal factor to one constant value — and
    deriving the one-hot set from the observed values would then build a
    design with fewer columns than the fitted Beta has rows (the
    ``predict(gradient=...)`` einsum shape failure).  Pandas categorical
    columns carry their level set explicitly, and :func:`design_matrix`
    already honours it; this helper installs the training levels.  A new
    value absent from the training levels is an error (the fitted model
    has no coefficient for it), matching R's ``model.matrix`` behaviour.
    """
    import pandas as pd

    if ref_df is None or not hasattr(df, "columns"):
        return df
    out = df.copy()
    for col in df.columns:
        if col not in getattr(ref_df, "columns", ()):
            continue
        ref = ref_df[col]
        ref_vals = np.asarray(ref)
        is_cat = (ref_vals.dtype.kind in "OUSb"
                  or str(getattr(ref, "dtype", "")) == "category")
        if not is_cat:
            continue
        cats = getattr(getattr(ref, "cat", None), "categories", None)
        if cats is None:
            cats = sorted({str(v) for v in ref_vals})
        else:
            cats = [str(c) for c in cats]
        new_vals = [str(v) for v in np.asarray(df[col])]
        unknown = sorted(set(new_vals) - set(cats))
        if unknown:
            raise ValueError(
                f"prediction data: factor {col!r} has level(s) {unknown} "
                f"absent from the fitted levels {cats} — the model has no "
                "coefficient for them")
        out[col] = pd.Categorical(new_vals, categories=cats)
    return out
