"""Post-hoc sign alignment across chains (reference
``R/alignPosterior.R:18-100``, called 5x after sampling).

Latent factors are identified only up to sign: for each level and factor, every
sample's (Lambda, Eta) pair is sign-flipped to correlate positively with the
cross-chain posterior-mean Lambda.  Reduced-rank regression components carry
the same ambiguity jointly in (wRRR, Beta/Gamma/V rows): each component is
flipped against the posterior-mean wRRR, with the paired Beta/Gamma rows and
V row+column flipped along (reference ``alignPosterior.R:77-100``; the
reference anchors on chain 1's mean — here the mean pools all healthy chains).
Host-side numpy over the stacked arrays.
"""

from __future__ import annotations

import numpy as np

__all__ = ["align_posterior"]


def align_posterior(post) -> int:
    """One alignment pass.  Returns the number of (chain, sample, factor)
    sign flips applied, so callers can iterate to a fixed point (the
    cross-chain mean moves with each pass) instead of a blind repeat count:
    0 means the pass was a no-op and the alignment has converged."""
    flips = 0
    gmask = post.good_chain_mask()
    for r in range(post.spec.nr):
        if f"Lambda_{r}" not in post.arrays:      # record=-restricted run
            continue
        lam = post.arrays[f"Lambda_{r}"]          # (c, s, nf, ns[, ncr])
        lam2 = lam[..., 0] if lam.ndim == 5 else lam
        mean_lam = lam2[gmask].mean(axis=(0, 1))  # (nf, ns)
        # per-sample correlation sign against the cross-chain mean
        num = np.einsum("csfj,fj->csf", lam2, mean_lam)
        sign = np.where(num < 0, -1.0, 1.0)       # (c, s, nf)
        flips += int((sign < 0).sum())
        # arrays may be read-only views of JAX buffers; multiply out-of-place
        if lam.ndim == 5:
            lam = lam * sign[..., None, None]
        else:
            lam = lam * sign[..., None]
        post.arrays[f"Lambda_{r}"] = lam
        if f"Eta_{r}" in post.arrays:
            post.arrays[f"Eta_{r}"] = (post.arrays[f"Eta_{r}"]
                                       * sign[:, :, None, :])

    spec = post.spec
    if spec.nc_rrr > 0 and "wRRR" in post.arrays:
        w = post.arrays["wRRR"]                   # (c, s, K, nc_orrr)
        mean_w = w[gmask].mean(axis=(0, 1))       # (K, nc_orrr)
        # centered correlation sign (the reference's cor(), :86)
        wc = w - w.mean(axis=-1, keepdims=True)
        mc = mean_w - mean_w.mean(axis=-1, keepdims=True)
        num = np.einsum("cskj,kj->csk", wc, mc)
        sign = np.where(num < 0, -1.0, 1.0)       # (c, s, K)
        flips += int((sign < 0).sum())
        ncn = spec.nc_nrrr
        post.arrays["wRRR"] = w * sign[..., None]
        B = np.array(post.arrays["Beta"])
        B[:, :, ncn:, :] = B[:, :, ncn:, :] * sign[..., None]
        post.arrays["Beta"] = B
        if "Gamma" in post.arrays:
            G = np.array(post.arrays["Gamma"])
            G[:, :, ncn:, :] = G[:, :, ncn:, :] * sign[..., None]
            post.arrays["Gamma"] = G
        if "V" in post.arrays:
            V = np.array(post.arrays["V"])
            V[:, :, ncn:, :] = V[:, :, ncn:, :] * sign[..., None]
            V[:, :, :, ncn:] = V[:, :, :, ncn:] * sign[:, :, None, :]
            post.arrays["V"] = V
    return flips
