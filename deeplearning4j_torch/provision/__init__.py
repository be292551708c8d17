"""GPU host provisioning: the cloud bring-up counterpart of the reference's
AWS module.

Counterpart of ``deeplearning4j_tpu/provision/`` (reference
``deeplearning4j-scaleout/deeplearning4j-aws``: ``ec2/Ec2BoxCreator.java``
spins up boxes from an AMI, ``ec2/provision/HostProvisioner.java`` uploads
and runs over ssh, ``ec2/provision/ClusterSetup.java`` launches the job,
``s3/`` stages datasets). The JAX package brings up a TPU pod slice; this
module brings up GPU hosts, each a Compute Engine instance carrying one
H100:

- boxes/AMI -> ``gcloud compute instances create`` with a machine type
  that carries one H100 (``a3-highgpu-1g``), an image family with the CUDA
  stack, ``--maintenance-policy TERMINATE`` (an instance with a GPU cannot
  live-migrate) and, where the JAX package asks for a preemptible slice, a
  spot instance;
- per-host ssh provisioning -> ``gcloud compute ssh`` / ``scp``: an
  instance is one host, so each host gets its own command (a pod slice's
  ``--worker=all`` fan-out has no counterpart);
- worker/parameter-server roles -> none: the process group is symmetric
  (``parallel/distributed.py``), so every host runs the same launch line;
- S3 dataset staging -> ``gsutil`` staging into the directory the
  fetchers read (``datasets/fetchers.py``).

Every command is built and returned (a dry run) unless ``run=True`` or an
injected runner executes it; :class:`PodLifecycle` executes through its
executor. The tests drive the whole lifecycle against a fake cloud.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shlex
import subprocess
import time
import types
from typing import Dict, List, Optional, Sequence, Union

__all__ = ["GpuHostConfig", "GpuHostProvisioner", "HostProvisioner", "GcsStager",
           "ClusterSetup", "PodLifecycle"]


@dataclasses.dataclass
class GpuHostConfig:
    """Reference ``Ec2BoxCreator``'s constructor (AMI, box size, security
    group) as one GPU host's parameters."""
    name: str
    zone: str
    machine_type: str = "a3-highgpu-1g"              # one H100 80GB
    image_family: str = "pytorch-latest-gpu"
    image_project: str = "deeplearning-platform-release"
    project: Optional[str] = None
    network: Optional[str] = None
    spot: bool = False
    tags: Dict[str, str] = dataclasses.field(default_factory=dict)


class GpuHostProvisioner:
    """Builds and runs one host's lifecycle commands (``Ec2BoxCreator``'s
    ``create``/``blowupBoxes``)."""

    def __init__(self, config: GpuHostConfig, runner=None):
        self.config = config
        self.custom_runner = runner is not None   # PodLifecycle honours it
        self._run = runner or (lambda cmd: subprocess.run(
            cmd, check=True, capture_output=True, text=True))

    def _base(self) -> List[str]:
        return ["gcloud", "compute", "instances"]

    def _scope(self) -> List[str]:
        c = self.config
        out = ["--zone", c.zone]
        if c.project:
            out += ["--project", c.project]
        return out

    def create_command(self) -> List[str]:
        c = self.config
        cmd = self._base() + ["create", c.name] + self._scope() + [
            "--machine-type", c.machine_type,
            "--image-family", c.image_family, "--image-project", c.image_project,
            "--maintenance-policy", "TERMINATE",
            # the image installs the driver on first boot when asked
            "--metadata", "install-nvidia-driver=True"]
        if c.network:
            cmd += ["--network", c.network]
        if c.spot:
            cmd += ["--provisioning-model", "SPOT"]
        if c.tags:
            # one comma-joined --labels flag: gcloud keeps only the last of
            # repeated dict flags
            cmd += ["--labels", ",".join(f"{k}={v}" for k, v in sorted(c.tags.items()))]
        return cmd

    def delete_command(self) -> List[str]:
        return self._base() + ["delete", self.config.name] + self._scope() + ["--quiet"]

    def describe_command(self) -> List[str]:
        """The instance's status alone (``RUNNING`` once it is up)."""
        return (self._base() + ["describe", self.config.name] + self._scope()
                + ["--format=value(status)"])

    def create(self, run: bool = False):
        cmd = self.create_command()
        return self._run(cmd) if run else cmd

    def delete(self, run: bool = False):
        cmd = self.delete_command()
        return self._run(cmd) if run else cmd


class HostProvisioner:
    """Reference ``HostProvisioner.java`` (upload, run) over ``gcloud
    compute ssh``/``scp`` to one host."""

    def __init__(self, provisioner: GpuHostProvisioner):
        self.p = provisioner

    def run_command(self, remote_cmd: str) -> List[str]:
        return (["gcloud", "compute", "ssh", self.p.config.name] + self.p._scope()
                + ["--command", remote_cmd])

    def upload_command(self, local_path: str, remote_path: str) -> List[str]:
        return (["gcloud", "compute", "scp", local_path,
                 f"{self.p.config.name}:{remote_path}"] + self.p._scope())

    def run(self, remote_cmd: str, run: bool = False):
        cmd = self.run_command(remote_cmd)
        return self.p._run(cmd) if run else cmd


class GcsStager:
    """Reference ``s3/uploader/S3Uploader`` + ``s3/reader/S3Downloader``
    as GCS staging into and out of the fetchers' data directory."""

    def __init__(self, bucket: str):
        self.bucket = bucket.rstrip("/")

    def upload_command(self, local_path: str, remote_name: str) -> List[str]:
        return ["gsutil", "-m", "cp", "-r", local_path, f"{self.bucket}/{remote_name}"]

    def download_command(self, remote_name: str, local_path: str) -> List[str]:
        return ["gsutil", "-m", "cp", "-r", f"{self.bucket}/{remote_name}", local_path]


class ClusterSetup:
    """Reference ``ClusterSetup.java``: provision the hosts, then launch.
    The process group is symmetric, so every host (one provisioner each)
    gets the same launch line; the coordinator is the first host
    (``parallel/distributed.py::initialize_distributed``)."""

    def __init__(self, provisioners: Union[GpuHostProvisioner, Sequence[GpuHostProvisioner]],
                 train_script: str = "train.py", env: Optional[Dict[str, str]] = None):
        self.provisioners = ([provisioners] if isinstance(provisioners, GpuHostProvisioner)
                             else list(provisioners))
        if not self.provisioners:
            raise ValueError("ClusterSetup needs at least one host provisioner")
        self.provisioner = self.provisioners[0]
        self.train_script = train_script
        self.env = dict(env or {})

    def launch_line(self) -> str:
        """The line every host runs: the environment, then the script."""
        return " ".join([f"{k}={shlex.quote(v)}" for k, v in sorted(self.env.items())]
                        + ["python3", shlex.quote(self.train_script)])

    def launch_command(self, provisioner: Optional[GpuHostProvisioner] = None) -> List[str]:
        """The launch on one host (the first by default)."""
        return HostProvisioner(provisioner or self.provisioner).run_command(self.launch_line())

    def plan(self) -> List[List[str]]:
        """The whole bring-up as a command list: every host's create, then
        every host's upload, then every host's launch."""
        hosts = [HostProvisioner(p) for p in self.provisioners]
        return ([p.create_command() for p in self.provisioners]
                + [h.upload_command(self.train_script, self.train_script) for h in hosts]
                + [self.launch_command(p) for p in self.provisioners])


class PodLifecycle:
    """The bring-up the tests rehearse, executable: the counterpart of the
    reference's ``ClusterSetup.java`` lifecycle (create the hosts, provision
    each, stage data, launch the job, tear down), with two properties a
    bring-up needs and the reference lacks:

    - **journaled re-entry**: each completed step is recorded (its name and
      its commands' hash) in a JSON journal; ``bringup()`` after a failure
      skips the completed steps and resumes at the first incomplete or
      changed one (editing a step's commands re-runs it);
    - **existence-aware create**: ``describe`` probes each host first, so an
      existing host is never created twice, even with a fresh journal; a
      ``describe`` that fails without saying "not found" raises instead of
      counting the host as gone.

    Every cloud call goes through ``executor`` (``cmd -> object with
    returncode/stdout/stderr``): by default a runner injected on the
    first host's provisioner, else ``subprocess.run``. A host is ready when
    its status reads ``RUNNING``."""

    #: the bring-up's steps in order (teardown is apart)
    STEPS = ("create", "wait_ready", "provision", "stage_data", "launch")

    def __init__(self, setup: ClusterSetup, stager: Optional[GcsStager] = None,
                 datasets: Optional[List[str]] = None,
                 setup_commands: Optional[List[str]] = None,
                 journal_path: Optional[str] = None, executor=None,
                 poll_interval_s: float = 10.0, ready_timeout_s: float = 900.0,
                 data_dir: str = "~/.deeplearning4j_tpu"):
        self.setup = setup
        self.provisioner = setup.provisioner
        self.provisioners = setup.provisioners
        self.stager = stager
        self.datasets = list(datasets or [])
        self.setup_commands = list(setup_commands or [])
        self.journal_path = journal_path or f".pod_lifecycle_{self.provisioner.config.name}.json"
        # an explicit executor, else a runner injected on the provisioner
        # (auth wrappers must not be bypassed), else subprocess; a runner
        # that raises on a nonzero exit reads as rc != 0 where it is probed
        if executor is not None:
            self._exec = executor
        elif self.provisioner.custom_runner:
            self._exec = self.provisioner._run
        else:
            self._exec = lambda cmd: subprocess.run(cmd, capture_output=True, text=True)
        self.poll_interval_s = poll_interval_s
        self.ready_timeout_s = ready_timeout_s
        self.data_dir = data_dir

    # ------------------------------------------------------------- journal
    def _load_journal(self) -> Dict:
        try:
            with open(self.journal_path) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return {}

    def _save_journal(self, journal: Dict):
        tmp = self.journal_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(journal, fh, indent=2)
        os.replace(tmp, self.journal_path)

    @staticmethod
    def _hash(cmds: List[List[str]]) -> str:
        return hashlib.sha256(json.dumps(cmds, sort_keys=True).encode()).hexdigest()[:16]

    # --------------------------------------------------------------- steps
    def _step_commands(self, step: str) -> List[List[str]]:
        """The commands a step runs on every host (inspectable, and what
        the journal hashes)."""
        if step == "create":
            return [p.create_command() for p in self.provisioners]
        if step == "wait_ready":
            return [p.describe_command() for p in self.provisioners]
        out: List[List[str]] = []
        for p in self.provisioners:
            host = HostProvisioner(p)
            if step == "provision":
                out.append(host.upload_command(self.setup.train_script,
                                               self.setup.train_script))
                out += [host.run_command(c) for c in self.setup_commands]
            elif step == "stage_data":
                out += [host.run_command(c) for c in self._stage_lines()]
            elif step == "launch":
                out.append(self.setup.launch_command(p))
            else:
                raise ValueError(f"unknown step {step!r}")
        return out

    def _stage_lines(self) -> List[str]:
        if not (self.stager and self.datasets):
            return []

        def expr(path: str) -> str:
            # "~" must reach the remote shell expandable: quoted, it would
            # stage into a literal "./~" while the fetchers expand the home
            if path.startswith("~/"):
                return '"$HOME"' + shlex.quote(path[1:])
            return shlex.quote(path)

        out = []
        for name in self.datasets:
            dst = f"{self.data_dir}/{name}"
            parts = self.stager.download_command(name, dst)
            cmd = " ".join(map(shlex.quote, parts[:-1])) + " " + expr(dst)
            # make the parent only and remove a partial copy first: `gsutil
            # cp -r` into an existing directory nests the dataset a level
            # deeper, which the fetchers do not see (also on a retry)
            out.append(f"mkdir -p {expr(self.data_dir)} && rm -rf {expr(dst)} && {cmd}")
        return out

    def _describe(self, provisioner: GpuHostProvisioner):
        """``describe``, with a raising runner's failure read as rc != 0."""
        try:
            return self._exec(provisioner.describe_command())
        except subprocess.CalledProcessError as e:
            return types.SimpleNamespace(returncode=e.returncode or 1, stdout=e.stdout or "",
                                         stderr=e.stderr or "")

    def _host_exists(self, provisioner: GpuHostProvisioner) -> bool:
        """True or False from ``describe``; a failure that is not an
        explicit not-found (auth, rate limit, network) raises: counting
        the host as gone would wipe the journal and launch the job again
        on a live host."""
        r = self._describe(provisioner)
        if r.returncode == 0:
            return True
        err = (getattr(r, "stderr", "") or "").lower()
        if "not_found" in err or "not found" in err or "404" in err:
            return False
        raise RuntimeError(
            f"describe failed transiently (rc={r.returncode}): {err[-300:] or 'no stderr'} — "
            f"cannot tell whether host {provisioner.config.name!r} exists; retry when the "
            f"control plane answers")

    def _wait_running(self, provisioner: GpuHostProvisioner):
        deadline = time.monotonic() + self.ready_timeout_s
        while True:
            r = self._describe(provisioner)
            if r.returncode == 0 and "RUNNING" in (getattr(r, "stdout", "") or ""):
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(f"host {provisioner.config.name} not RUNNING within "
                                   f"{self.ready_timeout_s:.0f}s (last describe "
                                   f"rc={r.returncode})")
            time.sleep(self.poll_interval_s)

    def _run_step(self, step: str):
        if step == "create":
            for p in self.provisioners:
                if not self._host_exists(p):          # the double-create guard
                    self._check(self._exec(p.create_command()), "create")
            return
        if step == "wait_ready":
            for p in self.provisioners:
                self._wait_running(p)
            return
        for cmd in self._step_commands(step):
            self._check(self._exec(cmd), step)

    @staticmethod
    def _check(result, step: str):
        rc = getattr(result, "returncode", 0)
        if rc:
            err = (getattr(result, "stderr", "") or "")[-500:]
            raise RuntimeError(f"lifecycle step {step!r} failed rc={rc}: {err}")

    # ----------------------------------------------------------- lifecycle
    def bringup(self) -> List[str]:
        """Run the steps in order, journaling each; returns the steps run
        by this call (journaled, unchanged ones are skipped). A journal is
        trusted only while every host still exists: a preempted or deleted
        host starts the bring-up over."""
        journal = self._load_journal()
        if journal and not all(self._host_exists(p) for p in self.provisioners):
            journal = {}
            self._save_journal(journal)
        ran: List[str] = []
        for step in self.STEPS:
            h = self._hash(self._step_commands(step))
            entry = journal.get(step)
            if entry and entry.get("done") and entry.get("hash") == h:
                continue
            self._run_step(step)
            ran.append(step)
            journal[step] = {"done": True, "hash": h}
            self._save_journal(journal)
        return ran

    def teardown(self, clear_journal: bool = True):
        """Delete every host that exists (a missing one is success) and, by
        default, clear the journal."""
        for p in self.provisioners:
            if self._host_exists(p):
                self._check(self._exec(p.delete_command()), "teardown")
        if clear_journal:
            try:
                os.remove(self.journal_path)
            except OSError:
                pass
