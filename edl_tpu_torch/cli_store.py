"""File-backed job store — the CLI↔controller-daemon exchange surface.

The reference's CLI (kubectl) talks to the controller through the K8s
API server (reference: doc/usage.md job walkthrough; watch plumbing at
pkg/controller.go:79-108). Standalone deployments here get a minimal
analog: a spool directory of job manifests (desired state, written by
``edl submit``) plus status records (observed state, written back by the
controller daemon). All writes are atomic (tmp + rename) so readers
never see torn JSON.

Layout under the store root:
    jobs/<namespace>.<name>.json     desired TrainingJob manifest
    status/<namespace>.<name>.json   controller-observed status
    cluster.json                     cluster resource census

The port of ``edl_tpu/cli/store.py``, unchanged in behaviour; it imports
no torch.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

from edl_tpu_torch.api.job import TrainingJob


def _atomic_write(path: str, text: str) -> None:
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class JobStore:
    def __init__(self, root: str):
        self.root = root
        self.jobs_dir = os.path.join(root, "jobs")
        self.status_dir = os.path.join(root, "status")
        os.makedirs(self.jobs_dir, exist_ok=True)
        os.makedirs(self.status_dir, exist_ok=True)

    @staticmethod
    def _key(namespace: str, name: str) -> str:
        return f"{namespace}.{name}"

    # -- desired state (written by the CLI) ---------------------------------

    def submit(self, job: TrainingJob) -> None:
        path = os.path.join(self.jobs_dir, self._key(job.namespace, job.name) + ".json")
        _atomic_write(path, json.dumps(job.to_dict(), indent=2))

    def delete(self, namespace: str, name: str) -> bool:
        found = False
        for d in (self.jobs_dir,):
            path = os.path.join(d, self._key(namespace, name) + ".json")
            try:
                os.unlink(path)
                found = True
            except FileNotFoundError:
                pass
        return found

    def list_keys(self) -> List[Tuple[str, str]]:
        """Sorted (namespace, name) pairs of submitted jobs."""
        out = []
        for fn in sorted(os.listdir(self.jobs_dir)):
            if fn.endswith(".json") and not fn.startswith("."):
                ns, _, name = fn[: -len(".json")].partition(".")
                out.append((ns, name))
        return out

    def load(self, namespace: str, name: str) -> Optional[TrainingJob]:
        path = os.path.join(self.jobs_dir, self._key(namespace, name) + ".json")
        try:
            with open(path) as f:
                return TrainingJob.from_dict(json.load(f))
        except FileNotFoundError:
            return None

    # -- observed state (written back by the controller daemon) -------------

    def write_status(self, namespace: str, name: str, status: Dict) -> None:
        path = os.path.join(
            self.status_dir, self._key(namespace, name) + ".json"
        )
        _atomic_write(path, json.dumps(status, indent=2))

    def read_status(self, namespace: str, name: str) -> Optional[Dict]:
        path = os.path.join(self.status_dir, self._key(namespace, name) + ".json")
        try:
            with open(path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def clear_status(self, namespace: str, name: str) -> None:
        path = os.path.join(self.status_dir, self._key(namespace, name) + ".json")
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass

    def list_statuses(self) -> Dict[Tuple[str, str], Dict]:
        out = {}
        for fn in sorted(os.listdir(self.status_dir)):
            if fn.endswith(".json") and not fn.startswith("."):
                ns, _, name = fn[: -len(".json")].partition(".")
                st = self.read_status(ns, name)
                if st is not None:
                    out[(ns, name)] = st
        return out

    # -- cluster census -----------------------------------------------------

    def write_cluster(self, census: Dict) -> None:
        _atomic_write(
            os.path.join(self.root, "cluster.json"), json.dumps(census, indent=2)
        )

    def read_cluster(self) -> Optional[Dict]:
        try:
            with open(os.path.join(self.root, "cluster.json")) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None
