"""GPU host provisioning (``deeplearning4j_torch/provision``) against the
JAX package's TPU pod provisioning (``tests/test_provision.py`` is the
oracle): the same cases on a GPU host's ``gcloud compute instances`` /
``ssh`` / ``scp`` command lines, and the same lifecycle rehearsed against
a fake cloud whose ``describe`` answers ``RUNNING`` (the JAX package's
reads ``READY``). Nothing runs without ``run=True`` or an injected runner.
"""
import subprocess
import types

import pytest

from deeplearning4j_torch.provision import (ClusterSetup, GcsStager, GpuHostConfig,
                                            GpuHostProvisioner, HostProvisioner, PodLifecycle)


def _cfg(name="bench-host", **kw):
    return GpuHostConfig(name=name, zone="us-central1-a", **kw)


def test_create_delete_describe_commands():
    p = GpuHostProvisioner(_cfg(project="proj-1", spot=True, network="net-a",
                                tags={"team": "ml", "env": "test"}))
    cmd = p.create_command()
    assert cmd[:5] == ["gcloud", "compute", "instances", "create", "bench-host"]
    assert cmd[cmd.index("--zone") + 1] == "us-central1-a"
    assert cmd[cmd.index("--project") + 1] == "proj-1"
    assert cmd[cmd.index("--machine-type") + 1] == "a3-highgpu-1g"
    assert "--image-family" in cmd and "--image-project" in cmd
    assert cmd[cmd.index("--maintenance-policy") + 1] == "TERMINATE"
    assert cmd[cmd.index("--provisioning-model") + 1] == "SPOT"
    assert cmd[cmd.index("--network") + 1] == "net-a"
    assert cmd.count("--labels") == 1 and cmd[cmd.index("--labels") + 1] == "env=test,team=ml"
    plain = GpuHostProvisioner(_cfg()).create_command()
    assert not {"--provisioning-model", "--labels", "--network", "--project"} & set(plain)
    d = p.delete_command()
    assert d[:5] == ["gcloud", "compute", "instances", "delete", "bench-host"]
    assert d[-1] == "--quiet"
    assert p.describe_command()[-1] == "--format=value(status)"


def test_host_provisioner_commands_reach_one_host():
    hosts = HostProvisioner(GpuHostProvisioner(_cfg()))
    cmd = hosts.run_command("pip install -e .")
    assert cmd[:4] == ["gcloud", "compute", "ssh", "bench-host"]
    assert cmd[cmd.index("--command") + 1] == "pip install -e ."
    assert "--worker" not in cmd
    up = hosts.upload_command("train.py", "/tmp/train.py")
    assert up[:5] == ["gcloud", "compute", "scp", "train.py", "bench-host:/tmp/train.py"]


def test_gcs_stager_commands():
    s = GcsStager("gs://my-bucket/data/")
    assert s.upload_command("/local/imagenet", "imagenet")[-1] == "gs://my-bucket/data/imagenet"
    assert s.download_command("imagenet", "/local/imagenet")[-2] == \
        "gs://my-bucket/data/imagenet"


def test_cluster_setup_plan_is_symmetric():
    """No parameter-server role: the same launch line on every host."""
    one = ClusterSetup(GpuHostProvisioner(_cfg()), train_script="train.py",
                       env={"NCCL_DEBUG": "WARN"}).plan()
    assert len(one) == 3 and "create" in one[0]
    assert any("train.py" in part for part in one[1])
    assert one[2][one[2].index("--command") + 1] == "NCCL_DEBUG=WARN python3 train.py"
    plan = ClusterSetup([GpuHostProvisioner(_cfg(f"h{i}")) for i in range(3)],
                        train_script="train.py").plan()
    assert [c[3] for c in plan[:3]] == ["create"] * 3
    launches = plan[6:]
    assert [c[3] for c in launches] == ["h0", "h1", "h2"]
    assert len({c[c.index("--command") + 1] for c in launches}) == 1
    with pytest.raises(ValueError):
        ClusterSetup([])


def test_nothing_runs_without_run_or_a_runner(monkeypatch):
    calls = []
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: calls.append(a) or None)
    p = GpuHostProvisioner(_cfg())
    assert p.create() == p.create_command() and p.delete() == p.delete_command()
    assert HostProvisioner(p).run("nvidia-smi") == HostProvisioner(p).run_command("nvidia-smi")
    ClusterSetup(p).plan()
    assert calls == []
    p.create(run=True)
    assert calls == [(p.create_command(),)]


def test_runner_injection_executes_commands():
    calls = []
    p = GpuHostProvisioner(_cfg(), runner=lambda cmd: calls.append(cmd) or "ok")
    assert p.create(run=True) == "ok" and p.delete(run=True) == "ok"
    assert HostProvisioner(p).run("nvidia-smi", run=True) == "ok"
    assert [c[3] for c in calls[:2]] == ["create", "delete"] and calls[2][2] == "ssh"


# ----------------------------------------------------- lifecycle rehearsal
class _FakeCloud:
    """gcloud/gsutil stand-in: tracks which hosts exist, answers
    ``describe`` with ``RUNNING`` after ``ready_after`` calls, and fails
    the commands ``fail_on`` picks."""

    def __init__(self, ready_after=2, fail_on=None):
        self.calls = []
        self.exists = set()
        self.describes = 0
        self.ready_after = ready_after
        self.fail_on = fail_on or (lambda cmd: False)

    @staticmethod
    def verb(cmd):
        if cmd[:3] == ["gcloud", "compute", "instances"]:
            return cmd[3]
        return cmd[2] if cmd[:2] == ["gcloud", "compute"] else cmd[0]

    def __call__(self, cmd):
        self.calls.append(cmd)
        ns = types.SimpleNamespace
        if self.fail_on(cmd):
            return ns(returncode=1, stdout="", stderr="injected failure")
        verb = self.verb(cmd)
        if verb == "create":
            self.exists.add(cmd[4])
        elif verb == "delete":
            self.exists.discard(cmd[4])
        elif verb == "describe":
            if cmd[4] not in self.exists:
                return ns(returncode=1, stdout="",
                          stderr=f"ERROR: The resource '{cmd[4]}' was not found")
            self.describes += 1
            return ns(returncode=0, stderr="",
                      stdout="RUNNING" if self.describes >= self.ready_after else "STAGING")
        return ns(returncode=0, stdout="", stderr="")

    def verbs(self):
        return [self.verb(c) for c in self.calls]


def _lifecycle(tmp_path, cloud, hosts=("bench-host",)):
    setup = ClusterSetup([GpuHostProvisioner(_cfg(h)) for h in hosts], train_script="train.py",
                         env={"NCCL_DEBUG": "WARN"})
    return PodLifecycle(setup, stager=GcsStager("gs://bkt/data"), datasets=["imagenet"],
                        setup_commands=["pip install deeplearning4j_torch"],
                        journal_path=str(tmp_path / "journal.json"), executor=cloud,
                        poll_interval_s=0.0, ready_timeout_s=30.0)


def test_lifecycle_full_bringup_ordering_and_teardown(tmp_path):
    cloud = _FakeCloud(ready_after=3)
    lc = _lifecycle(tmp_path, cloud)
    assert lc.bringup() == ["create", "wait_ready", "provision", "stage_data", "launch"]
    v = cloud.verbs()
    assert v[:2] == ["describe", "create"] and v.count("describe") >= 4
    first = v.index("scp")
    assert all(x == "describe" for x in v[2:first])
    assert v[first:] == ["scp", "ssh", "ssh", "ssh"]
    stage = cloud.calls[-2]
    assert "gsutil" in stage[stage.index("--command") + 1]
    launch = cloud.calls[-1]
    assert launch[launch.index("--command") + 1] == "NCCL_DEBUG=WARN python3 train.py"
    lc.teardown()
    assert cloud.verbs()[-1] == "delete" and not cloud.exists
    lc.teardown()
    assert cloud.verbs().count("delete") == 1


def test_lifecycle_reaches_every_host(tmp_path):
    cloud = _FakeCloud(ready_after=1)
    lc = _lifecycle(tmp_path, cloud, hosts=("h0", "h1"))
    lc.bringup()
    assert cloud.exists == {"h0", "h1"}
    launches = [c for c in cloud.calls if c[2] == "ssh" and "python3" in c[-1]]
    assert [c[3] for c in launches] == ["h0", "h1"]
    cloud.exists.discard("h1")                  # one host preempted
    assert lc.bringup() == list(lc.STEPS)
    assert cloud.verbs().count("create") == 3   # only the lost host again
    lc.teardown()
    assert not cloud.exists


def test_lifecycle_reentry_skips_completed_steps(tmp_path):
    cloud = _FakeCloud(ready_after=1)
    lc = _lifecycle(tmp_path, cloud)
    assert lc.bringup() == list(lc.STEPS)
    n = len(cloud.calls)
    assert lc.bringup() == []
    assert len(cloud.calls) == n + 1 and cloud.verbs()[-1] == "describe"
    (tmp_path / "b").mkdir()
    cloud2 = _FakeCloud(ready_after=1, fail_on=lambda cmd: "scp" in cmd)
    lc2 = _lifecycle(tmp_path / "b", cloud2)
    with pytest.raises(RuntimeError, match="provision"):
        lc2.bringup()
    cloud2.fail_on = lambda cmd: False
    assert lc2.bringup() == ["provision", "stage_data", "launch"]
    assert cloud2.verbs().count("create") == 1


def test_lifecycle_edited_step_reruns(tmp_path):
    cloud = _FakeCloud(ready_after=1)
    lc = _lifecycle(tmp_path, cloud)
    lc.bringup()
    lc.setup_commands.append("pip install extra-dep")
    assert lc.bringup() == ["provision"]


def test_lifecycle_double_create_guard_and_transient_describe(tmp_path):
    """An existing host is never created again; a describe that fails
    without "not found" raises instead of counting the host as gone."""
    cloud = _FakeCloud(ready_after=1)
    cloud.exists.add("bench-host")
    lc = _lifecycle(tmp_path, cloud)
    assert lc.bringup() == list(lc.STEPS) and "create" not in cloud.verbs()
    cloud.fail_on = lambda cmd: _FakeCloud.verb(cmd) == "describe"
    with pytest.raises(RuntimeError, match="transiently"):
        lc.bringup()
    assert (tmp_path / "journal.json").exists()


def test_lifecycle_ready_timeout(tmp_path):
    lc = _lifecycle(tmp_path, _FakeCloud(ready_after=10 ** 9))
    lc.ready_timeout_s = 0.2
    with pytest.raises(TimeoutError, match="RUNNING"):
        lc.bringup()


def test_lifecycle_preempted_host_invalidates_journal(tmp_path):
    cloud = _FakeCloud(ready_after=1)
    lc = _lifecycle(tmp_path, cloud)
    assert lc.bringup() == list(lc.STEPS)
    cloud.exists.clear()
    cloud.describes = 0
    assert lc.bringup() == list(lc.STEPS)
    assert cloud.verbs().count("create") == 2


def test_lifecycle_honors_provisioner_runner(tmp_path):
    calls = []

    def auth_runner(cmd):
        calls.append(cmd)
        out = "RUNNING" if _FakeCloud.verb(cmd) == "describe" else ""
        return types.SimpleNamespace(returncode=0, stdout=out, stderr="")

    prov = GpuHostProvisioner(_cfg(), runner=auth_runner)
    PodLifecycle(ClusterSetup(prov, train_script="t.py"), journal_path=str(tmp_path / "j.json"),
                 poll_interval_s=0.0).bringup()
    assert calls and calls[0][3] == "describe"

    def raising(cmd):                       # the default runner raises on rc != 0
        raise subprocess.CalledProcessError(1, cmd, output="", stderr="was not found")

    lc = PodLifecycle(ClusterSetup(GpuHostProvisioner(_cfg(), runner=raising)),
                      journal_path=str(tmp_path / "k.json"), poll_interval_s=0.0)
    assert lc._host_exists(lc.provisioner) is False


def test_lifecycle_stage_data_home_expansion(tmp_path):
    lc = _lifecycle(tmp_path, _FakeCloud(ready_after=1))
    [cmd] = lc._step_commands("stage_data")
    remote = cmd[cmd.index("--command") + 1]
    assert '"$HOME"' in remote and "'~" not in remote and remote.startswith("mkdir -p ")
    assert "rm -rf" in remote and remote.index("rm -rf") < remote.index("gsutil")
    assert "gs://bkt/data/imagenet" in remote
