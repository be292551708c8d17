"""The port's compile plane (``deeplearning4j_torch/compilecache/``): the
shared kernel-library cache and warmup artifacts.

The port's compile step is the ``nvcc`` build of its kernel libraries,
which this machine cannot run, so the tests fake the library files: bytes
written where ``cuda_build._target`` puts a source's library, with the
fingerprint sidecar a build writes. An exported artifact installs on a
replica with an empty cache directory under the same names and bytes, and
the replica answers exactly as the live model; garbage, a tampered
fingerprint, library, topology, precision or bucket set, and a JAX-written
artifact all fall back loudly (``compile_cache_miss``) to the live warmup;
a loader-only replica whose artifact is rejected starts cold; ``gc_cache``
evicts exactly what was built or exported under another fingerprint.
Comparisons are exact.
"""
import json
import os
import zipfile

import numpy as np
import pytest

from deeplearning4j_torch import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_torch.compilecache import artifacts, cache as cc
from deeplearning4j_torch.monitor import get_flight_recorder, get_registry, monitored_jit
from deeplearning4j_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_torch.ops import cuda_build
from deeplearning4j_torch.serving import ServedModel

SOURCES = ("lstm_cell.cu", "lstm_fused.cu")


@pytest.fixture(autouse=True)
def _cache_state():
    """The cache directory and its counters are process-global."""
    snap, fast = dict(cc._STATE), cc._ENABLED_FAST[0]
    get_flight_recorder().clear()
    yield
    cc._STATE.clear()
    cc._STATE.update(snap)
    cc._ENABLED_FAST[0] = fast


def _mlp(hidden=32, seed=7):
    conf = (NeuralNetConfiguration.builder().seed(seed).activation("tanh").list()
            .layer(DenseLayer(n_in=16, n_out=hidden))
            .layer(OutputLayer(n_in=hidden, n_out=4, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _fake_libraries(d, fingerprint=None):
    """Library files for SOURCES in cache directory ``d``, as a build
    leaves them (the library and its fingerprint sidecar)."""
    cc.enable(str(d))
    out = {}
    for i, src in enumerate(SOURCES):
        path = cuda_build._target(src)
        path.write_bytes(bytes([i + 1]) * 4096 + src.encode())
        path.with_suffix(".json").write_text(
            json.dumps({"source": src, **(fingerprint or cuda_build.fingerprint())}))
        out[src] = path
    return out


def _served(name, model=None, **kw):
    kw = {"batch_buckets": (1, 2), "input_shape": (16,), **kw}
    return ServedModel(name, model if model is not None else _mlp(), device="cpu", **kw)


#: the toolkit the exporter's libraries were built under (another than the
#: replica's, which may have none)
BUILDER_FP = {"nvcc": "Cuda compilation tools, release 12.4, V12.4.131",
              "flags": " ".join(cuda_build.NVCC_FLAGS), "arch": cuda_build.ARCH}


def _export(tmp_path, **kw):
    libs = _fake_libraries(tmp_path / "exporter", fingerprint=BUILDER_FP)
    src = _served("aot_src", warmup=True, **kw)
    path = artifacts.export_warmup_artifact(src, str(tmp_path / "out") + os.sep,
                                            sources=SOURCES)
    x = np.random.default_rng(3).normal(size=(2, 16)).astype(np.float32)
    ref = src.predict(x)
    src.close()
    return path, libs, x, ref


def _misses(name):
    return [e for e in get_flight_recorder().events()
            if e["event"] == "compile_cache_miss" and e.get("model") == name]


def test_export_then_install_round_trip(tmp_path, monkeypatch):
    """The artifact holds a manifest, the golden set and the libraries and
    nothing else; a replica on an empty cache directory installs the
    libraries under their names and bytes with the builder's fingerprint
    in their sidecars, runs no build and no ``nvcc --version``, adopts the
    golden set, and answers exactly as the exporter."""
    path, libs, x, ref = _export(tmp_path)

    def no_toolkit():
        raise AssertionError("the install asked the toolkit for its version")
    monkeypatch.setattr(cuda_build, "toolkit_version", no_toolkit)
    assert path.endswith(artifacts.ARTIFACT_EXT)
    with zipfile.ZipFile(path) as z:
        assert sorted(z.namelist()) == sorted(
            ["manifest.json", "golden.json"] + [f"lib/{p.name}" for p in libs.values()])
    man = artifacts.read_manifest(path)
    assert man["fingerprint"] == artifacts.runtime_fingerprint()
    assert man["fingerprint"]["arch"] == "sm_90a"
    assert [(s["shape"], s["dtype"], s["masked"]) for s in man["signatures"]] == \
        [([1, 16], "float32", False), ([2, 16], "float32", False)]
    assert {lib["source"] for lib in man["libraries"]} == set(SOURCES)
    assert all(lib["built"] == BUILDER_FP for lib in man["libraries"])

    cc.enable(str(tmp_path / "replica"))
    before = cc.persistent_cache_counts()
    twin = _served("aot_dst", warmup_artifact=path)
    try:
        for src, exported in libs.items():
            installed = cuda_build._target(src)
            assert installed.parent == tmp_path / "replica"
            assert installed.name == exported.name
            assert installed.read_bytes() == exported.read_bytes()
            assert json.loads(installed.with_suffix(".json").read_text()) == \
                {"source": src, **BUILDER_FP}
        assert cc.persistent_cache_counts()["misses"] == before["misses"]
        assert twin.stats()["aot_signatures"] == 2
        assert twin.golden()["version"] == man["golden_version"]
        assert twin.predict(x).tobytes() == ref.tobytes()
    finally:
        twin.close()
    loaded = [e for e in get_flight_recorder().events()
              if e["event"] == "compile_cache_artifact_loaded" and e["model"] == "aot_dst"]
    assert loaded and loaded[-1]["signatures"] == 2 and loaded[-1]["libraries"] == 2


def _rewrite(src, dst, edit_manifest=None, edit_member=None):
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            if name == "manifest.json" and edit_manifest:
                man = json.loads(data)
                edit_manifest(man)
                data = json.dumps(man).encode()
            if edit_member:
                data = edit_member(name, data)
            zout.writestr(name, data)
        if edit_member:
            extra = edit_member(None, None)
            if extra:
                zout.writestr(*extra)


def _fp(m):
    m["fingerprint"]["torch"] = "0.0-elsewhere"


def _precision(m):
    m["precision"] = "bf16"


def _libname(m):
    m["libraries"][0]["name"] = "liblstm_cell-000000000000.so"


def _flip(name, data):
    if name is not None and name.startswith("lib/"):
        return data[:-1] + bytes([data[-1] ^ 1])
    return data


def _extra(name, data):
    return ("notes.txt", b"x") if name is None else data


@pytest.mark.parametrize("case,reason", [
    ("garbage", ""), ("fingerprint", "fingerprint"), ("library_name", "is not what"),
    ("library_bytes", "sha256"), ("extra_member", "differ"), ("topology", "topology"),
    ("precision", "precision"), ("buckets", "bucket")])
def test_rejected_artifacts_fall_back_loudly(tmp_path, case, reason):
    """Every mismatch or corruption: a ``compile_cache_miss`` event naming
    it, nothing installed, the live warmup, and answers."""
    path, _, x, ref = _export(tmp_path)
    bad = str(tmp_path / f"{case}.dl4jaot")
    model, kw = None, {}
    if case == "garbage":
        with open(bad, "wb") as fh:
            fh.write(b"not a zip at all")
    elif case == "fingerprint":
        _rewrite(path, bad, edit_manifest=_fp)
    elif case == "library_name":
        _rewrite(path, bad, edit_manifest=_libname)
    elif case == "precision":
        _rewrite(path, bad, edit_manifest=_precision)
    elif case == "library_bytes":
        _rewrite(path, bad, edit_member=_flip)
    elif case == "extra_member":
        _rewrite(path, bad, edit_member=_extra)
    else:
        bad = path
        model = _mlp(hidden=24) if case == "topology" else None
        kw = {"batch_buckets": (1, 4)} if case == "buckets" else {}
    cc.enable(str(tmp_path / "replica"))
    m = _served(f"aot_{case}", model=model, warmup_artifact=bad, **kw)
    try:
        assert m._aot == set() and m.stats()["aot_signatures"] == 0
        assert not list((tmp_path / "replica").glob("lib*.so"))
        out = m.predict(x)
        assert out.shape == (2, 4)
        if case not in ("topology", "buckets"):
            assert out.tobytes() == ref.tobytes()
    finally:
        m.close()
    misses = _misses(f"aot_{case}")
    assert misses and reason in misses[-1]["reason"]


def test_loader_only_replica_with_a_rejected_artifact_starts_cold(tmp_path):
    garbage = tmp_path / "junk.dl4jaot"
    garbage.write_bytes(b"junk")
    m = ServedModel("aot_cold", _mlp(), device="cpu", batch_buckets=(1, 2),
                    warmup_artifact=str(garbage))
    try:
        assert m._aot == set() and m.input_shape is None
        assert m.predict(np.ones((1, 16), np.float32)).shape == (1, 4)
    finally:
        m.close()
    assert _misses("aot_cold")


def test_loader_only_replica_adopts_the_artifact_input_shape(tmp_path):
    path, _, x, ref = _export(tmp_path)
    cc.enable(str(tmp_path / "replica"))
    m = ServedModel("aot_loader", _mlp(), device="cpu", batch_buckets=(1, 2),
                    warmup_artifact=path)
    try:
        assert m.input_shape == (16,) and m.stats()["aot_signatures"] == 2
        assert m.predict(x).tobytes() == ref.tobytes()
    finally:
        m.close()


def test_jax_written_artifact_is_rejected(tmp_path):
    """An artifact of the JAX package (serialized XLA executables, format
    1) is refused by format, loudly."""
    from deeplearning4j_tpu import (NeuralNetConfiguration as JConf,
                                    MultiLayerNetwork as JNet, Sgd as JSgd)
    from deeplearning4j_tpu.nn.conf import layers as jl
    from deeplearning4j_tpu.serving.registry import ServedModel as JServed
    conf = (JConf.builder().seed(7).updater(JSgd(learning_rate=0.05)).activation("tanh").list()
            .layer(jl.DenseLayer(n_in=16, n_out=32))
            .layer(jl.OutputLayer(n_in=32, n_out=4, activation="softmax", loss="mcxent"))
            .build())
    jserved = JServed("jax_src", JNet(conf).init(), batch_buckets=(1, 2), input_shape=(16,),
                      warmup=True)
    try:
        jpath = jserved.export_warmup(str(tmp_path / "jax") + os.sep)
    finally:
        jserved.close()
    with pytest.raises(artifacts.ArtifactError, match="format"):
        artifacts.read_manifest(jpath)
    m = _served("aot_from_jax", warmup_artifact=jpath)
    try:
        assert m._aot == set()
    finally:
        m.close()
    assert "format" in _misses("aot_from_jax")[-1]["reason"]


def test_gc_evicts_other_fingerprints_and_stats_count(tmp_path):
    """Libraries of another toolkit, an artifact of another runtime and a
    killed build's temp file go; the current ones stay. Dry-run first."""
    d = tmp_path / "cache"
    current = _fake_libraries(d)
    stale = d / "libold-0123456789ab.so"
    stale.write_bytes(b"old")
    stale.with_suffix(".json").write_text(json.dumps({**cuda_build.fingerprint(),
                                                      "nvcc": "release 11.0"}))
    (d / "libnofp-0123456789ab.so").write_bytes(b"no sidecar")
    (d / "liblstm_cell-0123456789ab.12345.tmp").write_bytes(b"half")
    good, _, _, _ = _export(tmp_path)
    cc.enable(str(d))
    os.replace(good, d / os.path.basename(good))
    foreign = d / "foreign.dl4jaot"
    _rewrite(str(d / os.path.basename(good)), str(foreign), edit_manifest=_fp)
    stats = cc.cache_stats(str(d))
    assert (stats["entries"], stats["artifacts"]) == (4, 2) and stats["bytes"] > 8192
    dry = cc.gc_cache(str(d))
    evicted = {os.path.basename(e["path"]) for e in dry["evicted"]}
    assert evicted == {"libold-0123456789ab.so", "libnofp-0123456789ab.so",
                       "liblstm_cell-0123456789ab.12345.tmp", "foreign.dl4jaot"}
    assert dry["kept"] == 3 and stale.exists()
    done = cc.gc_cache(str(d), dry_run=False)
    assert all(e["removed"] for e in done["evicted"])
    assert not stale.exists() and not stale.with_suffix(".json").exists()
    assert all(p.exists() for p in current.values())
    assert cc.cache_stats(str(d))["artifacts"] == 1


def test_gc_evicts_an_installed_library_of_another_toolkit(tmp_path):
    """A replica's installed libraries carry their builder's fingerprint,
    so ``gc_cache`` there evicts those built under another ``nvcc`` than
    the running one, and keeps them under the same one."""
    path, libs, _, _ = _export(tmp_path)
    cc.enable(str(tmp_path / "replica"))
    twin = _served("aot_gc", warmup_artifact=path)
    twin.close()
    dry = cc.gc_cache(str(tmp_path / "replica"))
    assert {os.path.basename(e["path"]) for e in dry["evicted"]} == \
        {p.name for p in libs.values()}
    assert all("fingerprint mismatch" in e["reason"] for e in dry["evicted"])
    for p in libs.values():
        side = tmp_path / "replica" / p.with_suffix(".json").name
        side.write_text(json.dumps({"source": "x", **cuda_build.fingerprint()}))
    kept = cc.gc_cache(str(tmp_path / "replica"))
    assert not kept["evicted"] and kept["kept"] == len(libs)


def test_hits_misses_and_the_persistent_hit_claim(tmp_path, monkeypatch):
    """A library found on disk is a hit; a first call whose window saw one
    counts under ``jit_persistent_cache_hits_total``; a claim needs a hit
    inside the caller's window; the dial is read only when set."""
    monkeypatch.delenv(cc.ENV_DIR, raising=False)
    cc._STATE["dir"], cc._ENABLED_FAST[0] = None, False
    assert cc.maybe_enable() is None and not cc.enabled()
    monkeypatch.setenv(cc.ENV_DIR, str(tmp_path / "dial"))
    assert cc.maybe_enable() == str(tmp_path / "dial") and cc.enabled()
    assert cuda_build.build_dir() == tmp_path / "dial"
    _fake_libraries(tmp_path / "dial")
    h0 = cc.hits_count()
    assert cuda_build._start(SOURCES[0]) is None            # on disk: no nvcc
    assert cc.hits_count() == h0 + 1
    assert cc.claim_persistent_hit(h0) and not cc.claim_persistent_hit(h0 + 1)
    f = monitored_jit(lambda x: cuda_build._start(SOURCES[1]) or x, name="test/disk_hit")
    f(np.ones(2, np.float32))
    assert get_registry().counter("jit_persistent_cache_hits_total",
                                  fn="test/disk_hit").value == 1
    assert cc.hits_count() == h0 + 2
