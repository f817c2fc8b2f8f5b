"""GPU VM provisioning — the deeplearning4j-aws replacement.

Port of ``deeplearning4j_tpu/cloud/provision.py``. The reference's cloud
module (``deeplearning4j-aws``: ``ec2/Ec2BoxCreator`` boots EC2 instances,
``provision/HostProvisioner`` scp/ssh-bootstraps each box, ``s3/``
up/downloads datasets) maps here to: create a Compute Engine VM with one
H100 (machine type ``a3-highgpu-1g`` by default, the machine the port runs
on, where the JAX package creates a TPU VM), run a bootstrap command on it,
and move data through GCS. This module builds the exact ``gcloud``/``gsutil``
invocations and, only when the operator asks (``dry_run=False``), executes
them: command construction is pure and testable with no network.
"""

from __future__ import annotations

import shlex
import subprocess
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


@dataclass
class GpuVmSpec:
    """The Ec2BoxCreator analogue: what to boot. The a3 machine types come
    with their H100s attached, so no ``--accelerator`` flag is needed."""

    name: str
    zone: str
    machine_type: str = "a3-highgpu-1g"
    image_family: str = "pytorch-latest-cu124"
    image_project: str = "deeplearning-platform-release"
    boot_disk_gb: int = 200
    project: Optional[str] = None
    preemptible: bool = False
    network: Optional[str] = None
    tags: List[str] = field(default_factory=list)


class GpuProvisioner:
    """Builds gcloud commands for the VM's lifecycle and bootstrap
    (Ec2BoxCreator.create → create(); HostProvisioner's scp/ssh/bootstrap
    → copy_to/run_on; blowupBoxes → delete)."""

    def __init__(self, spec: GpuVmSpec, dry_run: bool = True):
        self.spec = spec
        self.dry_run = dry_run
        self.commands_issued: List[List[str]] = []

    # -- command builders (pure) ---------------------------------------
    def _base(self) -> List[str]:
        return ["gcloud", "compute"]

    def _common_flags(self) -> List[str]:
        flags = [f"--zone={self.spec.zone}"]
        if self.spec.project:
            flags.append(f"--project={self.spec.project}")
        return flags

    def create_command(self) -> List[str]:
        cmd = (self._base() + ["instances", "create", self.spec.name]
               + self._common_flags())
        cmd.append(f"--machine-type={self.spec.machine_type}")
        cmd.append(f"--image-family={self.spec.image_family}")
        cmd.append(f"--image-project={self.spec.image_project}")
        cmd.append(f"--boot-disk-size={self.spec.boot_disk_gb}GB")
        # a GPU VM cannot live-migrate
        cmd.append("--maintenance-policy=TERMINATE")
        if self.spec.preemptible:
            cmd.append("--provisioning-model=SPOT")
        if self.spec.network:
            cmd.append(f"--network={self.spec.network}")
        if self.spec.tags:
            cmd.append("--tags=" + ",".join(self.spec.tags))
        return cmd

    def delete_command(self) -> List[str]:
        return (self._base() + ["instances", "delete", self.spec.name]
                + self._common_flags() + ["--quiet"])

    def run_command(self, shell_cmd: str) -> List[str]:
        """ssh a command to the VM (HostProvisioner.runRemoteCommand)."""
        return (self._base() + ["ssh", self.spec.name] + self._common_flags()
                + [f"--command={shell_cmd}"])

    def copy_command(self, local_path: str, remote_path: str,
                     recurse: bool = False) -> List[str]:
        """scp files to the VM (HostProvisioner.uploadFile)."""
        cmd = self._base() + ["scp"]
        if recurse:
            cmd.append("--recurse")
        return (cmd + [local_path, f"{self.spec.name}:{remote_path}"]
                + self._common_flags())

    def bootstrap_commands(self, repo_dir: str,
                           extra_setup: Sequence[str] = ()) -> List[List[str]]:
        """Full bring-up: copy the repository, install it, sanity-check
        (HostProvisioner.bootstrap). Failures propagate: the install runs
        unmuffled and the sanity check imports the port and counts the
        cards."""
        cmds = [
            self.copy_command(repo_dir, "~/deeplearning4j_tpu", recurse=True),
            self.run_command("pip install -e ~/deeplearning4j_tpu"),
        ]
        for setup in extra_setup:
            cmds.append(self.run_command(setup))
        cmds.append(self.run_command(
            "python -c 'import deeplearning4j_tpu_torch, torch; "
            "print(torch.cuda.device_count())'"))
        return cmds

    # -- execution ------------------------------------------------------
    def _issue(self, cmd: List[str]) -> Optional[str]:
        self.commands_issued.append(cmd)
        if self.dry_run:
            return None
        out = subprocess.run(cmd, check=True, capture_output=True, text=True)
        return out.stdout

    def create(self) -> Optional[str]:
        return self._issue(self.create_command())

    def delete(self) -> Optional[str]:
        return self._issue(self.delete_command())

    def run(self, shell_cmd: str) -> Optional[str]:
        return self._issue(self.run_command(shell_cmd))

    def copy_to(self, local: str, remote: str) -> Optional[str]:
        return self._issue(self.copy_command(local, remote))

    def bootstrap(self, repo_dir: str,
                  extra_setup: Sequence[str] = ()) -> None:
        for cmd in self.bootstrap_commands(repo_dir, extra_setup):
            self._issue(cmd)

    def script(self) -> str:
        """Render issued commands as a reviewable shell script."""
        return "\n".join(" ".join(shlex.quote(a) for a in c)
                         for c in self.commands_issued)


class GcsTransfer:
    """Dataset up/download (s3/reader/S3Downloader.java,
    s3/uploader/S3Uploader.java) via gsutil commands; ``dry_run`` records
    the commands without executing, keeping tests hermetic. gs:// URIs
    only."""

    def __init__(self, dry_run: bool = True):
        self.dry_run = dry_run
        self.commands_issued: List[List[str]] = []

    def upload_command(self, local: str, gcs_uri: str) -> List[str]:
        if not gcs_uri.startswith("gs://"):
            raise ValueError("destination must be a gs:// URI")
        return ["gsutil", "-m", "cp", "-r", local, gcs_uri]

    def download_command(self, gcs_uri: str, local: str) -> List[str]:
        if not gcs_uri.startswith("gs://"):
            raise ValueError("source must be a gs:// URI")
        return ["gsutil", "-m", "cp", "-r", gcs_uri, local]

    def _issue(self, cmd: List[str]) -> None:
        self.commands_issued.append(cmd)
        if not self.dry_run:
            subprocess.run(cmd, check=True)

    def upload(self, local: str, gcs_uri: str) -> None:
        self._issue(self.upload_command(local, gcs_uri))

    def download(self, gcs_uri: str, local: str) -> None:
        self._issue(self.download_command(gcs_uri, local))
