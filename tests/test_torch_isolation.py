"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and every entry point
defaults to CUDA and raises on a host without a card."""

import ast
import pathlib

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ServeConfig
from repro_torch.models import Model
from repro_torch.models import transformer
from repro_torch.serve.engine import Engine
from repro_torch.weights import from_jax_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden_imports(source):
    """Imported module names whose top-level package is JAX or the JAX
    package; ``repro_torch`` is a different name and passes."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return bad


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference_package(path):
    assert _forbidden_imports(path.read_text()) == []


def test_import_scan_matches_module_names_exactly():
    src = ("import repro_torch.kernels\nfrom repro_torch import device\n"
           "import jax.numpy as jnp\nfrom repro.models import Model\n"
           "import reprox\n")
    assert _forbidden_imports(src) == ["jax.numpy", "repro.models"]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")


def test_entry_points_default_to_cuda_and_raise_without_it(no_card):
    cfg = get_config("nectar-relu-llama-1.7m")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        transformer.init_params(cfg, gen)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Model(cfg).init_paged_cache(2, 8, 8, 4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Model(cfg).init_cache(2, 8)
    params = Model(cfg).init(gen, device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Engine(cfg, params, ServeConfig(paged=True))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Engine(cfg, params, ServeConfig())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        from_jax_params({}, cfg)
    Engine(cfg, params, ServeConfig(paged=True), device="cpu")
