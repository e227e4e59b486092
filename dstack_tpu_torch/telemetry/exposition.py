"""Prometheus text-format exposition: hand-rolled parser + renderer.

Parity role: the reference leans on ``prometheus_client`` for parsing and
generation (services/prometheus/custom_metrics.py); that package is not in
this image, so the subset of the text format we need — ``# TYPE`` comments,
counter/gauge/histogram/summary samples with escaped label values, +Inf/NaN
numbers — is implemented here by hand.  The same module both parses scraped
job exposition and renders the server's republished ``/metrics`` output, so
a round-trip through it is self-consistent by construction (the CI step
``scripts/check_metrics_exposition.py`` enforces exactly that).

Format reference: https://prometheus.io/docs/instrumenting/exposition_formats/
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

#: metric/label name grammar from the exposition spec
_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: suffixes that attach histogram/summary component series to their family
#: name (``_total`` is NOT one: a counter's full name includes it and its
#: ``# TYPE`` line declares it verbatim in the classic text format)
_FAMILY_SUFFIXES = ("_bucket", "_sum", "_count")

VALID_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


class ExpositionError(ValueError):
    """Malformed exposition text (line number included in the message)."""


@dataclass
class Sample:
    """One sample line: ``name{labels} value``.

    Histograms/summaries arrive as their component series (``*_bucket`` with
    an ``le`` label, ``*_sum``, ``*_count``) — storing at sample granularity
    keeps them round-trippable without a dedicated histogram type.

    ``exemplar`` carries an OpenMetrics exemplar
    (``{"labels": {...}, "value": float, "timestamp": float | None}``) —
    rendered only when the scraper negotiates OpenMetrics
    (``render(..., openmetrics=True)``), because the classic text format
    has no exemplar syntax and a classic scraper must still parse the
    page.
    """

    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    value: float = 0.0
    type: str = "untyped"  # family type from the # TYPE comment
    exemplar: Optional[dict] = None


def family_of(name: str) -> str:
    """The metric family a series belongs to (strips histogram suffixes)."""
    for suffix in _FAMILY_SUFFIXES:
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def _parse_value(raw: str, lineno: int) -> float:
    raw = raw.strip()
    if raw in ("+Inf", "Inf"):
        return math.inf
    if raw == "-Inf":
        return -math.inf
    if raw == "NaN":
        return math.nan
    try:
        return float(raw)
    except ValueError:
        raise ExpositionError(f"line {lineno}: invalid value {raw!r}") from None


def _parse_labels(raw: str, lineno: int) -> Dict[str, str]:
    """Parse ``a="x",b="y\\"z"`` — a tiny state machine because label values
    may contain escaped quotes, backslashes, and newlines."""
    labels: Dict[str, str] = {}
    i, n = 0, len(raw)
    while i < n:
        while i < n and raw[i] in ", \t":
            i += 1
        if i >= n:
            break
        j = raw.find("=", i)
        if j < 0:
            raise ExpositionError(f"line {lineno}: malformed labels {raw!r}")
        name = raw[i:j].strip()
        if not _LABEL_RE.match(name):
            raise ExpositionError(f"line {lineno}: bad label name {name!r}")
        i = j + 1
        if i >= n or raw[i] != '"':
            raise ExpositionError(f"line {lineno}: unquoted label value")
        i += 1
        out: List[str] = []
        while i < n:
            c = raw[i]
            if c == "\\":
                if i + 1 >= n:
                    raise ExpositionError(f"line {lineno}: dangling escape")
                esc = raw[i + 1]
                out.append({"n": "\n", '"': '"', "\\": "\\"}.get(esc, "\\" + esc))
                i += 2
            elif c == '"':
                i += 1
                break
            else:
                out.append(c)
                i += 1
        else:
            raise ExpositionError(f"line {lineno}: unterminated label value")
        labels[name] = "".join(out)
    return labels


def parse(
    text: str,
    max_samples: int = 10_000,
    strict: bool = False,
) -> List[Sample]:
    """Parse exposition text into samples.

    ``strict=False`` (scrape path) skips unparsable lines — one bad line in a
    user exporter must not discard the rest of the scrape.  ``strict=True``
    (CI validation of our own /metrics output) raises on the first defect.
    """
    samples: List[Sample] = []
    types: Dict[str, str] = {}

    def fail(msg: str) -> None:
        raise ExpositionError(msg)

    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 2 and parts[1] == "TYPE":
                if len(parts) < 4 or parts[3] not in VALID_TYPES:
                    if strict:
                        fail(f"line {lineno}: malformed TYPE comment {line!r}")
                    continue
                if not _NAME_RE.match(parts[2]):
                    if strict:
                        fail(f"line {lineno}: bad metric name {parts[2]!r}")
                    continue
                if parts[2] in types and strict:
                    # Prometheus rejects a second TYPE line for a family and
                    # drops the whole scrape — our own output must never
                    # contain one (the CI gate parses strict)
                    fail(f"line {lineno}: duplicate TYPE for {parts[2]!r}")
                types[parts[2]] = parts[3]
            continue  # HELP and other comments are ignored
        if len(samples) >= max_samples:
            if strict:
                fail(f"more than {max_samples} samples")
            break
        try:
            sample = _parse_sample_line(line, lineno)
        except ExpositionError:
            if strict:
                raise
            continue
        # exact name first (classic counters: `# TYPE steps_total counter`),
        # then the histogram/summary family, then the OpenMetrics-style base
        # name without _total
        sample.type = (
            types.get(sample.name)
            or types.get(family_of(sample.name))
            or (
                types.get(sample.name[: -len("_total")])
                if sample.name.endswith("_total")
                else None
            )
            or "untyped"
        )
        samples.append(sample)
    return samples


def _find_label_end(rest: str) -> int:
    """Index of the label set's closing '}' — '}' inside a quoted label
    value is legal in the text format and must not terminate the set."""
    in_string = False
    i, n = 0, len(rest)
    while i < n:
        c = rest[i]
        if in_string:
            if c == "\\":
                i += 1  # skip the escaped char
            elif c == '"':
                in_string = False
        elif c == '"':
            in_string = True
        elif c == "}":
            return i
        i += 1
    return -1


def _parse_exemplar(raw: str, lineno: int) -> dict:
    """OpenMetrics exemplar: ``{label="v",...} value [timestamp]``."""
    raw = raw.strip()
    if not raw.startswith("{"):
        raise ExpositionError(f"line {lineno}: exemplar must start with "
                              f"a label set, got {raw!r}")
    end = _find_label_end(raw[1:])
    if end < 0:
        raise ExpositionError(f"line {lineno}: unterminated exemplar labels")
    labels = _parse_labels(raw[1:1 + end], lineno)
    fields = raw[2 + end:].split()
    if not fields or len(fields) > 2:
        raise ExpositionError(
            f"line {lineno}: exemplar needs a value (+ optional "
            f"timestamp), got {raw!r}")
    out = {"labels": labels, "value": _parse_value(fields[0], lineno),
           "timestamp": None}
    if len(fields) == 2:
        out["timestamp"] = _parse_value(fields[1], lineno)
    return out


def _parse_sample_line(line: str, lineno: int) -> Sample:
    # an OpenMetrics exemplar trails the value after " # "; split it off
    # first — '#' inside quoted label VALUES is protected because labels
    # are parsed via _find_label_end before the tail is inspected
    if "{" in line:
        name, _, rest = line.partition("{")
        end = _find_label_end(rest)
        if end < 0:
            raise ExpositionError(f"line {lineno}: unterminated label set")
        label_str, tail = rest[:end], rest[end + 1:]
        labels = _parse_labels(label_str, lineno)
    else:
        # spaces AND tabs separate tokens in the exposition format
        parts = line.split(None, 1)
        name, tail = parts[0], parts[1] if len(parts) > 1 else ""
        labels = {}
    exemplar = None
    if " # " in tail:
        tail, _, ex_raw = tail.partition(" # ")
        exemplar = _parse_exemplar(ex_raw, lineno)
    name = name.strip()
    if not _NAME_RE.match(name):
        raise ExpositionError(f"line {lineno}: bad metric name {name!r}")
    fields = tail.split()
    if not fields:
        raise ExpositionError(f"line {lineno}: missing value")
    # optional trailing timestamp (ignored — the server stamps collected_at)
    if len(fields) > 2:
        raise ExpositionError(f"line {lineno}: trailing garbage {tail!r}")
    return Sample(name=name, labels=labels,
                  value=_parse_value(fields[0], lineno), exemplar=exemplar)


# -- rendering --------------------------------------------------------------


def escape_label_value(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def format_value(value: float) -> str:
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if math.isnan(value):
        return "NaN"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def format_sample(
    name: str, labels: Optional[Dict[str, str]] = None, value: float = 0.0
) -> str:
    if labels:
        inner = ",".join(
            f'{k}="{escape_label_value(v)}"' for k, v in labels.items()
        )
        return f"{name}{{{inner}}} {format_value(value)}"
    return f"{name} {format_value(value)}"


def format_exemplar(exemplar: dict) -> str:
    """OpenMetrics exemplar suffix (without the leading ``" # "``)."""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"'
        for k, v in (exemplar.get("labels") or {}).items()
    )
    out = f"{{{inner}}} {format_value(exemplar.get('value', 0.0))}"
    ts = exemplar.get("timestamp")
    if ts is not None:
        out += f" {repr(float(ts))}"
    return out


def render(samples: Iterable[Sample], openmetrics: bool = False) -> List[str]:
    """Render samples grouped by family, emitting one ``# TYPE`` per family.

    ``openmetrics=True`` appends exemplars (`` # {trace_id="..."} v ts``)
    to samples that carry one — only for scrapers that negotiated the
    OpenMetrics content type; the classic text format has no exemplar
    syntax, so classic pages stay exemplar-free and parse everywhere.

    The exposition format requires all series of a family to be consecutive
    and declared AT MOST ONCE — so grouping is by family name alone; when
    two sources disagree on a family's type (two jobs exporting the same
    metric name differently), the first declaration wins rather than
    emitting a duplicate TYPE line that would fail a real Prometheus scrape.
    """
    by_family: Dict[str, List[Sample]] = {}
    family_type: Dict[str, str] = {}
    order: List[str] = []
    for s in samples:
        # only histogram/summary component series roll up under a stripped
        # family name — a plain gauge named e.g. error_count is its own
        # family and must be declared under its full name
        family = (
            family_of(s.name) if s.type in ("histogram", "summary")
            else s.name
        )
        if family not in by_family:
            by_family[family] = []
            family_type[family] = s.type or "untyped"
            order.append(family)
        elif family_type[family] == "untyped" and s.type not in (None, "untyped"):
            family_type[family] = s.type
        by_family[family].append(s)
    lines: List[str] = []
    for family in order:
        lines.append(f"# TYPE {family} {family_type[family]}")
        for s in by_family[family]:
            line = format_sample(s.name, s.labels, s.value)
            if openmetrics and s.exemplar is not None:
                line += " # " + format_exemplar(s.exemplar)
            lines.append(line)
    return lines
