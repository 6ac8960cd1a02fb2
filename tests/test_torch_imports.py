"""The port stands alone: no module of ``hmsc_tpu_torch``, not
``chip_smoke.py`` and none of the scripts that run on the card imports
JAX, the JAX package or ``ml_dtypes`` (which the card's machine does not
have), its entry point refuses
to fall back to the CPU when no card is present, and ``chip_smoke.py``
fails (prints no result) without a card or without the repository."""

import ast
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
# the scripts/ that run on the card (the *_jax_* ones run the JAX package
# on the CPU)
CARD_SCRIPTS = ("kernel_checks.py", "gpp_quad_sweep.py",
                "serve_predict_sweep.py", "serve_kernel_sweep.py",
                "gram_tile_sweep.py", "headline_ab.py",
                "serve_conditional_sweep.py", "slice_ab.py",
                "vecchia_cg_sweep.py", "probit_z_sweep.py",
                "nngp_quad_sweep.py", "nngp_dense_iw_sweep.py",
                "shrinkage_sweep.py", "gamma_v_sweep.py",
                "mvn_prec_sweep.py", "precision_ab.py")
PORT_FILES = sorted((REPO / "hmsc_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"] + [REPO / "scripts" / n for n in CARD_SCRIPTS]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "hmsc_tpu", "ml_dtypes")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_hmsc_tpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__"):
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{path.name} imports {bad}"


def test_sample_mcmc_without_device_raises_when_no_card():
    import hmsc_tpu_torch
    from hmsc_tpu_torch.mcmc.sampler import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    hM = hmsc_tpu_torch.Hmsc(Y=(torch.rand(5, 2) > 0.5).numpy(),
                             distr="probit")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hmsc_tpu_torch.sample_mcmc(hM, samples=1)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(where, tmp_path):
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real")
    cwd = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                       capture_output=True, text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                            "PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
