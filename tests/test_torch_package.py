"""The port stands alone and runs on the card unless told otherwise.

- A fresh interpreter that imports and runs the port has neither ``jax``
  nor ``deeplearning4j_tpu`` in ``sys.modules``.
- No source file of the port (nor ``chip_smoke.py``) imports either.
- With no CUDA device, every entry point that defaults to the card raises
  instead of falling back to the CPU.
- Every subpackage's ``__all__`` holds the JAX package's names (the
  provisioning's under the GPU host's names), and ``analysis/`` alone is
  still to port.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "deeplearning4j_torch"
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread per test worker leaves the other
    cores to the workers running other test files."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix() for p in
                                        [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_no_source_imports_jax_or_the_jax_package(path):
    bad = sorted(set(_imported_roots(ROOT / path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_running_the_port_loads_no_jax(tmp_path):
    code = """
import json, sys
import numpy as np
from deeplearning4j_torch import NeuralNetConfiguration, MultiLayerNetwork, InferenceServer
from deeplearning4j_torch.nn.conf.layers import GravesLSTM, RnnOutputLayer
from deeplearning4j_torch.utils.model_serializer import restore_multi_layer_network
conf = (NeuralNetConfiguration.builder().seed(1).activation("tanh").list()
        .layer(GravesLSTM(n_in=4, n_out=8)).layer(GravesLSTM(n_in=8, n_out=8))
        .layer(RnnOutputLayer(n_in=8, n_out=4, activation="softmax")).build())
net = MultiLayerNetwork(conf).init(device="cpu")
x = np.eye(4, dtype=np.float32)[np.arange(6).reshape(2, 3) % 4]
y = net.output(x, mask=np.ones((2, 3), np.float32)) + net.output(x)
net.fit(x, x)
srv = InferenceServer()
srv.register("m", net, device="cpu")
srv.registry.predict("m", x)
srv.stop()
from deeplearning4j_torch.models import TransformerLM
lm = TransformerLM(vocab_size=5, embed_dim=8, num_heads=2, num_blocks=1).init(device="cpu")
ids = np.arange(8, dtype=np.float32).reshape(2, 4) % 5
lm.fit(ids, np.eye(5, dtype=np.float32)[ids.astype(int)])
lm.output(ids)
from deeplearning4j_torch.models import generate_tokens
from deeplearning4j_torch.utils.model_guesser import load_model_guess
from deeplearning4j_torch.utils.model_serializer import write_model
generate_tokens(load_model_guess(write_model(lm, "lm.zip"), device="cpu"), [[1, 2]], 3)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu"))))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    from deeplearning4j_torch import (MultiLayerNetwork, NeuralNetConfiguration,
                                      resolve_device)
    from deeplearning4j_torch.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_torch.serving import ServedModel
    from deeplearning4j_torch.utils.model_guesser import load_model_guess
    from deeplearning4j_torch.utils.model_serializer import (restore_model,
                                                             restore_multi_layer_network)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = (NeuralNetConfiguration.builder().list()
            .layer(DenseLayer(n_in=3, n_out=4))
            .layer(OutputLayer(n_in=4, n_out=2, activation="softmax")).build())
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiLayerNetwork(conf).init()
    cpu_net = MultiLayerNetwork(conf).init(device="cpu")
    assert cpu_net.output([[1.0, 2.0, 3.0]]).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        ServedModel("m", cpu_net)
    for restore in (restore_multi_layer_network, restore_model, load_model_guess):
        with pytest.raises(RuntimeError, match="CUDA"):
            restore(tmp_path / "missing.zip")           # before any read
    from deeplearning4j_torch.models import LeNet, ResNet50, TextGenerationLSTM, TransformerLM
    for model in (LeNet(), ResNet50(), TextGenerationLSTM(), TransformerLM()):
        with pytest.raises(RuntimeError, match="CUDA"):
            model.init()
    with pytest.raises(RuntimeError, match="CUDA"):
        ServedModel("zoo", TextGenerationLSTM())        # a ZooModel is built on the card
    assert LeNet().init(device="cpu").device.type == "cpu"


def test_dense_network_matches_jax_package():
    """The feed-forward layers of the slice against the JAX package, f32."""
    import numpy as np
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn.conf import layers as jl
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_torch.nn.conf import serde
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.utils.model_serializer import params_from_numpy

    jconf = (JConf.builder().seed(5).list()
             .layer(jl.DenseLayer(n_in=6, n_out=8, activation="relu"))
             .layer(jl.OutputLayer(n_in=8, n_out=3, activation="softmax")).build())
    jnet = JNet(jconf).init()
    conf = serde.decode(json.loads(jconf.to_json()))
    arrays = {f"{i}/{k}": np.asarray(v) for i, p in jnet.params.items()
              for k, v in p.items()}
    net = MultiLayerNetwork(conf).init(params=params_from_numpy(conf, arrays),
                                       device="cpu")
    x = np.random.default_rng(0).standard_normal((5, 6)).astype(np.float32)
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(jnet.output(x)),
                               rtol=0, atol=1e-5)


JAX_PKG = ROOT / "deeplearning4j_tpu"
#: JAX names still to port, by subpackage (none left)
STILL_TO_PORT = {}
#: JAX names with a counterpart under another name: the GPU host's
#: provisioning in place of the TPU pod's
RENAMED = {"provision": {"TpuPodConfig": "GpuHostConfig",
                         "TpuPodProvisioner": "GpuHostProvisioner"}}
#: JAX subpackages with no counterpart yet: analysis/ (ROADMAP A 17h)
NOT_PORTED = {"analysis"}


@pytest.mark.parametrize("sub", sorted(p.name for p in JAX_PKG.iterdir()
                                       if (p / "__init__.py").exists()))
def test_subpackage_all_holds_the_jax_names(sub):
    """Every subpackage's ``__all__`` holds every name of the JAX
    package's (monitor and control: the same list), under its port name
    where ``RENAMED`` gives one, but for the names still to port."""
    import importlib
    if sub in NOT_PORTED:
        assert not (PORT / sub).exists()
        return
    jax_all = importlib.import_module(f"deeplearning4j_tpu.{sub}").__dict__.get("__all__")
    port = importlib.import_module(f"deeplearning4j_torch.{sub}")
    port_all = port.__dict__.get("__all__")
    if jax_all is None:
        assert port_all is None or all(hasattr(port, n) for n in port_all)
        return
    assert port_all is not None, f"deeplearning4j_torch.{sub} has no __all__"
    renamed = RENAMED.get(sub, {})
    jax_all = [renamed.get(n, n) for n in jax_all]
    assert set(jax_all) - set(port_all) == STILL_TO_PORT.get(sub, set())
    assert all(hasattr(port, n) for n in port_all)
    if sub in ("monitor", "control"):
        assert port_all == jax_all
