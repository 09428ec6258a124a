"""Prometheus text exposition of the shared ``Metrics`` (``GET /prom`` of
``runtime.expo``). Port of ``opencv_facerecognizer_tpu/runtime/promtext.py``:
the same ``Metrics`` state renders to the same bytes in both packages.

``render`` turns one atomic ``Metrics.export_state()`` snapshot into the
text format (``text/plain; version=0.0.4``):

- counters -> ``ocvf_<name>_total`` (TYPE counter);
- gauges -> ``ocvf_<name>`` (TYPE gauge);
- latency windows (merged over the whole window) -> ``ocvf_<name>_seconds``
  histograms: cumulative ``_bucket{le=...}`` on ``utils.histogram``'s
  bounds, ``_sum`` and ``_count``;
- the dynamic families (``frames_rejected_<reason>``,
  ``batcher_dropped_<reason>``, ``slo_burn_<objective>``,
  ``slo_events_<reason>``, ``track_flushes_<reason>``,
  ``transport_fault_<kind>``, ``router_rejected_<reason>``,
  ``stage_share_b<bucket>_<stage>``) fold into one metric each with a
  label, its value escaped (``\\``, ``\"``, ``\n``).

``lint_prometheus_text`` is a strict well-formedness check of a body.
Families are sorted, so scrapes diff cleanly.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

from opencv_facerecognizer_tpu_torch.utils import metrics as mn

#: every family name this module emits is prefixed with this namespace.
NAMESPACE = "ocvf"

#: prefix family -> (metric name, label key); ``stage_share_`` is parsed
#: into two labels (``b<bucket>_<stage>``) below
_LABEL_FAMILIES: Tuple[Tuple[str, str, str], ...] = (
    (mn.FRAMES_REJECTED_PREFIX, "frames_rejected", "reason"),
    (mn.BATCHER_DROPPED_PREFIX, "batcher_dropped", "reason"),
    (mn.SLO_EVENTS_PREFIX, "slo_events", "reason"),
    (mn.SLO_BURN_PREFIX, "slo_burn", "objective"),
    (mn.TRACK_FLUSHES_PREFIX, "track_flushes", "reason"),
    (mn.TRANSPORT_FAULTS_PREFIX, "transport_fault", "kind"),
    (mn.ROUTER_REJECTED_PREFIX, "router_rejected", "reason"),
)

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")
_STAGE_SHARE_RE = re.compile(r"b(\d+)_([a-zA-Z0-9_]+)$")


def escape_label_value(value: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def escape_help(text: str) -> str:
    """HELP-line escaping: backslash and newline (quotes are legal there)."""
    return str(text).replace("\\", r"\\").replace("\n", r"\n")


def _fmt(value: float) -> str:
    """Sample-value formatting: integers render bare (1 not 1.0), +Inf as
    ``+Inf``, NaN as ``NaN`` (both legal sample values in the format)."""
    f = float(value)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _sanitize(name: str) -> str:
    """Metric names on the shared surface are snake_case already; anything
    else (defensive) maps to underscores so the exposition never emits an
    ill-formed family name."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", str(name))
    if not out or not _NAME_RE.match(out):
        out = "_" + out
    return out


class _Family:
    """One metric family being assembled: TYPE + HELP + sample lines."""

    def __init__(self, name: str, kind: str, help_text: str = ""):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.samples: List[str] = []

    def add(self, value: float, labels: Optional[Dict[str, str]] = None,
            suffix: str = "") -> None:
        label_s = ""
        if labels:
            inner = ",".join(
                f'{k}="{escape_label_value(v)}"'
                for k, v in sorted(labels.items()))
            label_s = "{" + inner + "}"
        self.samples.append(f"{self.name}{suffix}{label_s} {_fmt(value)}")

    def render(self) -> str:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {escape_help(self.help)}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        lines.extend(self.samples)
        return "\n".join(lines)


def _fold_family(name: str) -> Optional[Tuple[str, Dict[str, str]]]:
    """``(family metric name, labels)`` when ``name`` belongs to a
    registered dynamic prefix family; None for plain names."""
    if name.startswith(mn.STAGE_SHARE_PREFIX):
        m = _STAGE_SHARE_RE.match(name[len(mn.STAGE_SHARE_PREFIX):])
        if m:
            return "stage_share", {"bucket": m.group(1), "stage": m.group(2)}
        return None
    for prefix, family, label in _LABEL_FAMILIES:
        if name.startswith(prefix) and len(name) > len(prefix):
            return family, {label: name[len(prefix):]}
    return None


def render(metrics, namespace: str = NAMESPACE) -> str:
    """The full exposition for one ``Metrics`` object (module docstring).
    One atomic snapshot; deterministic ordering (sorted families) so
    scrapes diff cleanly."""
    counters, gauges, hists = metrics.export_state()
    families: Dict[str, _Family] = {}

    def family(raw: str, kind: str, labels=None, help_text: str = ""):
        folded = _fold_family(raw)
        if folded is not None:
            base, fold_labels = folded
            labels = {**(labels or {}), **fold_labels}
        else:
            base = _sanitize(raw)
        if kind == "counter":
            base += "_total"
        name = f"{namespace}_{base}"
        fam = families.get(name)
        if fam is None:
            fam = families[name] = _Family(name, kind, help_text)
        return fam, labels

    for raw, value in counters.items():
        fam, labels = family(raw, "counter")
        fam.add(value, labels)
    for raw, value in gauges.items():
        fam, labels = family(raw, "gauge")
        fam.add(value, labels)
    for raw, snap in hists.items():
        name = f"{namespace}_{_sanitize(raw)}_seconds"
        fam = families.setdefault(name, _Family(
            name, "histogram",
            "rolling log-bucket latency window (utils.histogram)"))
        cum = 0
        for bound, count in zip(snap["bounds"], snap["counts"]):
            cum += count
            fam.add(cum, {"le": _fmt(bound)}, suffix="_bucket")
        fam.add(snap["count"], {"le": "+Inf"}, suffix="_bucket")
        fam.add(snap["sum"], suffix="_sum")
        fam.add(snap["count"], suffix="_count")
    body = "\n".join(families[name].render() for name in sorted(families))
    return body + "\n" if body else ""


# ---- the format lint ----

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r" (?P<value>\S+)(?: \d+)?$")
_LABEL_RE = re.compile(
    r'(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<val>(?:[^"\\]|\\.)*)"')


def _split_labels(blob: str) -> Optional[Dict[str, str]]:
    """Parse a label body strictly: comma-separated ``k="v"`` pairs with
    only legal escapes inside values. None on malformed input."""
    labels: Dict[str, str] = {}
    pos = 0
    while pos < len(blob):
        m = _LABEL_RE.match(blob, pos)
        if m is None:
            return None
        val = m.group("val")
        # only \\, \" and \n are legal escapes, checked pairwise
        i = 0
        while i < len(val):
            if val[i] == "\\":
                if i + 1 >= len(val) or val[i + 1] not in '\\"n':
                    return None
                i += 2
            else:
                i += 1
        labels[m.group("key")] = val
        pos = m.end()
        if pos < len(blob):
            if blob[pos] != ",":
                return None
            pos += 1
    return labels


def _base_family(name: str) -> str:
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def lint_prometheus_text(text: str) -> List[str]:
    """Well-formedness findings for one exposition body (empty = clean):
    name and label grammar, one TYPE per family before its samples,
    cumulative histogram buckets with ``+Inf`` == ``_count``, parsable
    values. The contract ``render`` claims."""
    findings: List[str] = []
    typed: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], str, int]] = []
    seen_sample_for: set = set()
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                findings.append(f"line {i}: malformed TYPE line: {line!r}")
                continue
            fam = parts[2]
            if not _NAME_RE.match(fam):
                findings.append(f"line {i}: bad family name {fam!r}")
            if fam in typed:
                findings.append(f"line {i}: duplicate TYPE for {fam}")
            if fam in seen_sample_for:
                findings.append(f"line {i}: TYPE for {fam} after its samples")
            typed[fam] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            findings.append(f"line {i}: unparseable sample: {line!r}")
            continue
        name = m.group("name")
        labels = _split_labels(m.group("labels") or "")
        if labels is None:
            findings.append(f"line {i}: malformed labels: {line!r}")
            continue
        for key in labels:
            if not _LABEL_NAME_RE.match(key):
                findings.append(f"line {i}: bad label name {key!r}")
        value = m.group("value")
        if value not in ("+Inf", "-Inf", "NaN"):
            try:
                float(value)
            except ValueError:
                findings.append(f"line {i}: unparseable value {value!r}")
        seen_sample_for.add(_base_family(name))
        samples.append((name, labels, value, i))
    # family/TYPE pairing: every sample's base family must be typed, and a
    # histogram family's samples must use the histogram suffixes.
    for name, labels, value, i in samples:
        base = _base_family(name)
        kind = typed.get(base) or typed.get(name)
        if kind is None:
            findings.append(f"line {i}: sample {name} has no TYPE")
            continue
        if kind == "histogram" and typed.get(name) is None:
            if not name.endswith(("_bucket", "_sum", "_count")):
                findings.append(
                    f"line {i}: histogram sample {name} lacks a "
                    f"_bucket/_sum/_count suffix")
            if name.endswith("_bucket") and "le" not in labels:
                findings.append(f"line {i}: _bucket sample without le label")
    # histogram coherence
    for fam, kind in typed.items():
        if kind != "histogram":
            continue
        buckets = [(lab.get("le"), val) for n, lab, val, _ in samples
                   if n == f"{fam}_bucket"]
        counts = [val for n, _, val, _ in samples if n == f"{fam}_count"]
        if not buckets:
            findings.append(f"histogram {fam} has no _bucket samples")
            continue
        if buckets[-1][0] != "+Inf":
            findings.append(f"histogram {fam} missing le=\"+Inf\" bucket")
        cum = [float(v) for _, v in buckets]
        if any(b > a for a, b in zip(cum[1:], cum)):
            findings.append(f"histogram {fam} bucket counts not cumulative")
        if counts and buckets[-1][0] == "+Inf" \
                and float(counts[0]) != cum[-1]:
            findings.append(
                f"histogram {fam} +Inf bucket {cum[-1]} != _count {counts[0]}")
        if not any(n == f"{fam}_sum" for n, _, _, _ in samples):
            findings.append(f"histogram {fam} missing _sum")
    return findings
