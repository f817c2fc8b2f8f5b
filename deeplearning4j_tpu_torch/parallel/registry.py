"""Cluster configuration registry.

Port of ``deeplearning4j_tpu/parallel/registry.py``, the re-design of
``deeplearning4j-scaleout-zookeeper`` (ZooKeeperConfigurationRegister/
Retriever): the reference keeps a member's runtime config in a ZooKeeper
znode ``/<host>/<task>``; here it is a JSON file ``<root>/<host>/<task>.json``
on a directory every worker mounts (NFS, a bucket mount, local for tests),
published atomically (tempfile + ``os.replace``), with mtime watches and
the same register/retrieve surface. The directory format is the
reference's, so either package reads what the other publishes. The
launcher writes it and the workers read it; no quorum service is needed.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.resilience import (
    FaultInjected,
    RetryError,
    RetryPolicy,
    faults,
    no_jitter,
)
from deeplearning4j_tpu_torch.utils.fileio import atomic_write_text

_NAME_RE = re.compile(r"\A[A-Za-z0-9._-]+\Z")


class ConfigRegistry:
    """register/retrieve/list/watch named JSON configs
    (ZooKeeperConfigurationRegister.java / ZooKeeperConfigurationRetriever)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, host: str, task: str) -> str:
        # the reference's znode path scheme: /<host>/<task>; names are
        # validated so no value can escape the registry root
        for name in (host, task):
            if not name or not _NAME_RE.match(name) or name in (".", ".."):
                raise ValueError(
                    f"invalid registry name {name!r}: use letters, digits, "
                    f"'.', '_', '-'")
        return os.path.join(self.root, host, task + ".json")

    # -- write ----------------------------------------------------------
    def register(self, host: str, task: str,
                 config: Dict[str, Any]) -> None:
        path = self._path(host, task)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        atomic_write_text(path, json.dumps(config))

    def unregister(self, host: str, task: str) -> None:
        try:
            os.unlink(self._path(host, task))
        except FileNotFoundError:
            pass

    # -- read -----------------------------------------------------------
    def retrieve(self, host: str, task: str) -> Dict[str, Any]:
        faults.fault_point("registry.retrieve")
        try:
            with open(self._path(host, task)) as f:
                return json.load(f)
        except FileNotFoundError:
            raise KeyError(f"no config registered for {host}/{task}")

    def exists(self, host: str, task: str) -> bool:
        return os.path.exists(self._path(host, task))

    def tasks(self, host: str) -> List[str]:
        d = os.path.join(self.root, host)
        if not os.path.isdir(d):
            return []
        return sorted(p[:-5] for p in os.listdir(d) if p.endswith(".json"))

    def hosts(self) -> List[str]:
        return sorted(h for h in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, h)))

    # -- watch ----------------------------------------------------------
    def wait_for(self, host: str, task: str, timeout_s: float = 30.0,
                 poll_s: float = 0.1,
                 policy: Optional[RetryPolicy] = None) -> Dict[str, Any]:
        """Block until a config appears (the worker-side retrieve-with-retry
        the reference does against ZooKeeper). The poll loop is the shared
        :class:`RetryPolicy` — by default a fixed ``poll_s`` interval
        (multiplier=1, no jitter) bounded by ``timeout_s``; pass ``policy``
        for backoff/jitter or an injectable sleep in tests. Transient read
        faults (injected or real) are retried like not-yet-registered."""
        self._path(host, task)  # invalid names fail NOW, not after the
        # full timeout — only transient conditions belong in the poll loop
        if policy is None:
            policy = RetryPolicy(max_attempts=None, deadline_s=timeout_s,
                                 base_delay_s=poll_s, multiplier=1.0,
                                 rng=no_jitter,
                                 retryable=(KeyError, OSError,
                                            json.JSONDecodeError,
                                            FaultInjected))
        try:
            return policy.call(self.retrieve, host, task)
        except RetryError as e:
            raise TimeoutError(f"config {host}/{task} not registered "
                               f"within {timeout_s}s") from e.last

    def watch(self, host: str, task: str,
              callback: Callable[[Optional[Dict[str, Any]]], None],
              timeout_s: float = 30.0,
              poll_s: float = 0.1) -> None:
        """Invoke ``callback`` on the next change (mtime watch). Deletion is
        a change too: the callback receives ``None`` when the config was
        unregistered."""
        path = self._path(host, task)

        def _sig():
            # mtime alone misses same-tick rewrites on coarse-granularity
            # shared media (GCS-fuse/NFS): fold in size. (Not st_ino —
            # gcsfuse inodes are synthetic and churn on cache eviction,
            # which would fire spurious change callbacks.)
            try:
                st = os.stat(path)
            except FileNotFoundError:
                return None
            return (st.st_mtime_ns, st.st_size)

        last = _sig()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            sig = _sig()
            if sig != last:
                try:
                    payload = (self.retrieve(host, task)
                               if sig is not None else None)
                except KeyError:  # deleted between stat and read
                    payload = None
                callback(payload)
                return
            time.sleep(poll_s)
        raise TimeoutError(f"no change on {host}/{task} within {timeout_s}s")
