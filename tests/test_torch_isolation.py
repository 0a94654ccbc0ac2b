"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and every entry point
(serving and training) defaults to CUDA and raises on a host without a
card."""

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


# the modules of the disagg and fleet slice, named so that a move or a
# rename fails here instead of dropping out of PORT_FILES' scan
SLICE_FILES = ("serve/disagg/__init__.py", "serve/disagg/coordinator.py",
               "serve/fleet.py", "serve/router.py", "dist/__init__.py",
               "dist/elastic.py")


# the modules of the recurrent families' slice, named for the same reason
RECURRENT_FILES = ("models/ssm.py", "models/xlstm.py",
                   "configs/zamba2_2_7b.py", "configs/xlstm_125m.py")


# the modules of the dispatch, prefetch and model-family slice
FAMILY_FILES = ("core/heterogeneous.py", "core/prefetch.py", "models/moe.py",
                "configs/qwen3_4b.py", "configs/qwen2_5_3b.py",
                "configs/moonshot_v1_16b_a3b.py",
                "configs/llama4_maverick_400b_a17b.py")


# the modules of the training slice
TRAIN_FILES = ("train/__init__.py", "train/optimizer.py", "train/data.py",
               "train/checkpoint.py", "train/fault.py", "train/loop.py",
               "dist/compression.py", "models/flash.py", "launch/train.py",
               "tree.py")


# the modules of the multi-device slice
MESH_FILES = ("launch/mesh.py", "dist/sharding.py", "dist/collectives.py",
              "dist/ring.py", "dist/elastic.py", "train/loop.py")


@pytest.mark.parametrize("name", SLICE_FILES + RECURRENT_FILES
                         + FAMILY_FILES + TRAIN_FILES + MESH_FILES)
def test_disagg_and_fleet_modules_import_no_jax(name):
    path = ROOT / "src" / "repro_torch" / name
    assert path in PORT_FILES
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
    # the training slice's: the loop, the CLI, restore, the optimizer state
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train as train_cli
    from repro_torch.train import checkpoint, data
    from repro_torch.train.loop import run_training
    from repro_torch.weights import from_jax_opt_state
    src = data.TinyStoriesSynth(data.DataConfig(seq_len=8, batch_size=1))
    for call in (lambda: run_training(Model(cfg), cfg, TrainConfig(), src,
                                      steps=1),
                 lambda: train_cli.main(["--steps", "1"]),
                 lambda: checkpoint.restore("unread", 1, {}),
                 lambda: from_jax_opt_state(None, cfg)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    Engine(cfg, params, ServeConfig(paged=True), device="cpu")


def test_disagg_and_fleet_entry_points_raise_without_a_card(no_card):
    from repro_torch.serve.disagg import DisaggCoordinator
    from repro_torch.serve.fleet import Fleet
    from repro_torch.serve.router import build_fleet
    cfg = get_config("nectar-relu-llama-1.7m")
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    scfg = ServeConfig(paged=True, max_batch=2, max_seq=32, block_size=8)
    for make in (lambda: DisaggCoordinator(cfg, params, scfg),
                 lambda: Fleet(cfg, params, scfg, n_replicas=1),
                 lambda: build_fleet(cfg, params, scfg, n_replicas=1)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    assert DisaggCoordinator(cfg, params, scfg, device="cpu").prefill \
        .device.type == "cpu"
    assert build_fleet(cfg, params, scfg, n_replicas=1, device="cpu") \
        .fleet.live()[0].engine.device.type == "cpu"


def test_training_entry_points_raise_without_a_card(no_card, tmp_path):
    """run_training, the train CLI, checkpoint.restore and
    from_jax_opt_state default to CUDA and raise without a card; with
    device="cpu" they run."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train as train_cli
    from repro_torch.train import checkpoint, data, optimizer
    from repro_torch.train.loop import run_training
    from repro_torch.weights import from_jax_opt_state
    cfg = get_config("nectar-relu-llama-smoke")
    src = data.TinyStoriesSynth(data.DataConfig(seq_len=8, batch_size=1))
    tcfg = TrainConfig(warmup_steps=1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run_training(Model(cfg), cfg, tcfg, src, steps=1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_cli.main(["--arch", cfg.name, "--steps", "1",
                        "--ckpt-dir", str(tmp_path)])
    params, state, info = run_training(Model(cfg), cfg, tcfg, src, steps=1,
                                       device="cpu")
    assert info["steps_done"] == 1
    checkpoint.save(str(tmp_path), 1, {"params": params})
    with pytest.raises(RuntimeError, match='device="cpu"'):
        checkpoint.restore(str(tmp_path), 1, {"params": params})
    with pytest.raises(RuntimeError, match='device="cpu"'):
        from_jax_opt_state(optimizer.adam_init(params), cfg)
    from repro_torch.core.sparsity import SparsityStats
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SparsityStats.init(cfg.n_layers)


def test_active_chip_defaults_to_cuda_and_raises_without_it(no_card):
    from repro_torch.roofline import hw
    with pytest.raises(RuntimeError, match='device="cpu"'):
        hw.active_chip()
    assert hw.active_chip("cpu") is hw.CPU_HOST


def test_mesh_entry_points_default_to_cuda_and_raise_without_it(no_card):
    """make_serving_mesh, a sharded Engine with no device list, and a mesh
    for compile_train_step made with no device list take the visible CUDA
    devices and raise without a card; a device list runs them."""
    from repro_torch.configs.base import MeshConfig, TrainConfig
    from repro_torch.launch.mesh import make_mesh, make_serving_mesh
    from repro_torch.train.loop import compile_train_step
    cfg = get_config("nectar-relu-llama-smoke")
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    mcfg = MeshConfig(model=2)
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_serving_mesh(mcfg)
    with pytest.raises(ValueError, match="needs 2 devices"):
        Engine(cfg, params, ServeConfig(paged=True, mesh=mcfg))
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh((1, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Engine(cfg, params, ServeConfig(paged=True, mesh=mcfg),
               device=["cuda:0"] * 2)
    mesh = make_mesh((1, 2), ("data", "model"), ["cpu"] * 2)
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32)}
    fn, _ = compile_train_step(cfg, TrainConfig(), mesh, params, None, batch)
    assert callable(fn)
    assert Engine(cfg, params, ServeConfig(paged=True, mesh=mcfg),
                  device=["cpu"] * 2).mesh.devices[1].type == "cpu"
