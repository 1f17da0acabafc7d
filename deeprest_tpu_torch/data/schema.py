"""The raw-telemetry data contract (``deeprest_tpu/data/schema.py``, copied
whole: the port reads and writes the same corpora).

The reference defines this contract only informally, as the pickle layout its
ETL must produce (reference: resource-estimation/README.md:29-63 and the
3-bucket example raw_data.pkl): an ordered list of time buckets, one per
monitoring scrape window, each holding

    {"metrics": [{"component": str, "resource": str, "value": float}, ...],
     "traces":  [span-tree, ...]}

where a span tree is ``{"component": str, "operation": str, "children": [...]}``.

Here the contract is typed and has two on-disk encodings:

1. the reference-compatible pickle of plain dicts (so reference corpora load
   unchanged), and
2. a streaming-friendly JSON-lines encoding (one bucket per line) that the
   featurizer and the workload simulator both speak — the explicit ETL
   artifact the reference leaves implicit (SURVEY.md §L2).
"""

from __future__ import annotations

import dataclasses
import io
import json
import pickle
from typing import Any, Iterable, Iterator, Mapping, Sequence


@dataclasses.dataclass
class Span:
    """One node of a distributed-trace span tree."""

    component: str
    operation: str
    children: list["Span"] = dataclasses.field(default_factory=list)

    @property
    def label(self) -> str:
        # The per-node feature-space token; the reference joins with "_"
        # (reference: resource-estimation/featurize.py:13) which is ambiguous
        # when component names contain underscores — kept for parity, the
        # call-path key itself is a tuple so no ambiguity leaks upward.
        return f"{self.component}_{self.operation}"

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Span":
        return cls(
            component=str(d["component"]),
            operation=str(d["operation"]),
            children=[cls.from_dict(c) for c in d.get("children", ())],
        )

    def to_dict(self) -> dict[str, Any]:
        return {
            "component": self.component,
            "operation": self.operation,
            "children": [c.to_dict() for c in self.children],
        }

    def walk(self, prefix: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], "Span"]]:
        """Yield (root-to-node call path, node) for every node in the tree."""
        path = prefix + (self.label,)
        yield path, self
        for child in self.children:
            yield from child.walk(path)


@dataclasses.dataclass
class MetricSample:
    """One resource measurement for one component in one time bucket."""

    component: str
    resource: str
    value: float

    @property
    def key(self) -> str:
        return f"{self.component}_{self.resource}"

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MetricSample":
        return cls(str(d["component"]), str(d["resource"]), float(d["value"]))

    def to_dict(self) -> dict[str, Any]:
        return {
            "component": self.component,
            "resource": self.resource,
            "value": self.value,
        }


@dataclasses.dataclass
class Bucket:
    """One monitoring time window: resource measurements + the traces in it."""

    metrics: list[MetricSample] = dataclasses.field(default_factory=list)
    traces: list[Span] = dataclasses.field(default_factory=list)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Bucket":
        return cls(
            metrics=[MetricSample.from_dict(m) for m in d.get("metrics", ())],
            traces=[Span.from_dict(t) for t in d.get("traces", ())],
        )

    def to_dict(self) -> dict[str, Any]:
        return {
            "metrics": [m.to_dict() for m in self.metrics],
            "traces": [t.to_dict() for t in self.traces],
        }


# --------------------------------------------------------------------------
# Loading / saving


def load_raw_data(path: str) -> list[Bucket]:
    """Load a corpus from either encoding, sniffed by content.

    Accepts the reference pickle layout unchanged and the JSONL encoding.
    """
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head[:1] in (b"{", b"["):  # JSONL (or a single JSON array)
            text = io.TextIOWrapper(f, encoding="utf-8")
            first = text.read(1)
            text.seek(0)
            if first == "[":
                return [Bucket.from_dict(b) for b in json.load(text)]
            return [Bucket.from_dict(json.loads(line)) for line in text if line.strip()]
        raw = pickle.load(f)
    return [Bucket.from_dict(b) for b in raw]


def save_raw_data_pickle(buckets: Sequence[Bucket], path: str) -> None:
    """Write the reference-compatible pickle-of-dicts encoding."""
    with open(path, "wb") as f:
        pickle.dump([b.to_dict() for b in buckets], f)


def save_raw_data_jsonl(buckets: Iterable[Bucket], path: str) -> None:
    """Write the streaming JSONL encoding (one bucket per line).  Each line
    is one ``json.dumps`` (the C encoder; ``json.dump`` to a file takes the
    pure-Python one), byte for byte what the JAX package writes."""
    with open(path, "w", encoding="utf-8") as f:
        for b in buckets:
            f.write(json.dumps(b.to_dict(), separators=(",", ":")))
            f.write("\n")


def iter_raw_data_jsonl(path: str) -> Iterator[Bucket]:
    """Stream buckets from a JSONL corpus without loading it whole."""
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if line.strip():
                yield Bucket.from_dict(json.loads(line))
