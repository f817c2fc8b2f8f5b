"""Checked-in finding baseline: adopt a rule without a flag-day fix.

Port of ``deeplearning4j_tpu/analysis/baseline.py``; the fingerprints are
the reference's, byte for byte. A baseline entry fingerprints a KNOWN
finding so the CLI reports only new ones. The fingerprint hashes (rule,
path, enclosing symbol, normalized source line) — deliberately NOT the
line number, so edits elsewhere in the file neither resurrect nor hide a
baselined finding; moving or rewording the offending line DOES
invalidate its entry: touched code must come clean.

The shipped baseline stays EMPTY (the file is absent): true positives
get fixed, genuine exceptions get inline
``# dl4j-lint: disable=<rule> -- reason`` suppressions where the code
is. The mechanism exists for future rule additions whose backlog cannot
land in one change.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
from typing import Dict, Iterable, List, Sequence, Tuple

from deeplearning4j_tpu_torch.analysis.engine import Finding, REPO_ROOT

__all__ = [
    "DEFAULT_BASELINE",
    "fingerprint",
    "load_baseline",
    "save_baseline",
    "partition_findings",
]

DEFAULT_BASELINE = os.path.join(REPO_ROOT, ".dl4j-lint-torch-baseline.json")
_VERSION = 1


@functools.lru_cache(maxsize=512)
def _read_lines(path: str, _stamp) -> Tuple[str, ...]:
    """``_stamp`` (mtime_ns, size) keys the cache so an edited file is
    re-read while fingerprinting many findings of one file costs one
    read, not one per finding."""
    try:
        with open(path, encoding="utf-8") as f:
            return tuple(f.read().splitlines())
    except OSError:
        return ()


def _line_text(finding: Finding, root: str) -> str:
    if finding.line < 1:  # parse-error findings anchor at line 0
        return ""
    path = os.path.join(root, finding.path)
    try:
        st = os.stat(path)
    except OSError:
        return ""
    lines = _read_lines(path, (st.st_mtime_ns, st.st_size))
    try:
        return lines[finding.line - 1].strip()
    except IndexError:
        return ""


def fingerprint(finding: Finding, root: str = REPO_ROOT) -> str:
    payload = "|".join((finding.rule, finding.path, finding.symbol,
                        _line_text(finding, root)))
    return hashlib.sha1(payload.encode("utf-8")).hexdigest()[:16]


def load_baseline(path: str = DEFAULT_BASELINE) -> Dict[str, dict]:
    """fingerprint -> entry; empty when the file is absent (the shipped
    state) or unreadable."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(data, dict) or data.get("version") != _VERSION:
        return {}
    return {e["fingerprint"]: e for e in data.get("entries", [])
            if isinstance(e, dict) and "fingerprint" in e}


def save_baseline(findings: Sequence[Finding], path: str = DEFAULT_BASELINE,
                  root: str = REPO_ROOT,
                  preserve: Sequence[dict] = ()) -> int:
    """Snapshot ``findings`` as the new baseline; returns the entry count.
    ``preserve`` carries existing entries a narrowed run could not have
    re-found (other rules / unscanned paths) forward unchanged."""
    entries = []
    seen = set()
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        fp = fingerprint(f, root)
        if fp in seen:
            continue
        seen.add(fp)
        entries.append({
            "fingerprint": fp,
            "rule": f.rule,
            "path": f.path,
            "symbol": f.symbol,
            "line": f.line,  # informational only; not part of the hash
            "text": _line_text(f, root),
        })
    for e in preserve:
        fp = e.get("fingerprint")
        if fp and fp not in seen:
            seen.add(fp)
            entries.append(e)
    payload = {"version": _VERSION, "entries": entries}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return len(entries)


def partition_findings(findings: Iterable[Finding],
                       baseline: Dict[str, dict],
                       root: str = REPO_ROOT
                       ) -> Tuple[List[Finding], List[Finding]]:
    """(new, baselined) split of ``findings`` against ``baseline``."""
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        (old if fingerprint(f, root) in baseline else new).append(f)
    return new, old
