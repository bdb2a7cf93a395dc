"""Communication/memory cost model over recorded entry points.

Counterpart of ``tpu_dist/analysis/costmodel.py``. The reference prices a
traced jaxpr; the port prices what :mod:`~tpu_dist_torch.analysis.
trace_checks`' recorder logged while one rank ran the entry point on a
fake process group: every ``c10d`` collective and point-to-point op with
its payload, its group and its peer, every tensor's lifetime, and the
matmul/convolution shapes. Nothing runs on a card.

**Communication volume.** Every recorded launch contributes
``bytes_on_wire = comm_bytes(op, payload_bytes, P)`` where

* ``payload_bytes`` is the operand's size as this rank launched it (the
  input of a gather or an all-to-all, the buffer of an all-reduce);
* ``P`` is the size of the launch's process group — overridable per mesh
  axis with a modeled mesh (``--mesh data=8,model=4``), the group's axis
  being the one whose slice of the entry's mesh equals the group's ranks;
* the formula is the reference's ring cost per device: all-reduce
  ``2*(P-1)/P``, all-gather ``(P-1)`` (of the per-rank input),
  reduce-scatter/all-to-all ``(P-1)/P``, a send ``1`` (the reference's
  ppermute: one neighbour send); a recv costs 0 (its bytes are the
  sender's), a broadcast ``1`` (each rank receives the buffer once) and a
  barrier 0. Identical launches (op, axis, shape, dtype) are merged into
  one site whose ``multiplier`` is their count, as the reference's scan
  multiplier counts a launch site's trips.

**Peak live bytes.** The recorder tracks every tensor storage an op
creates on the recorded device from its allocation to its last reference
(a weak reference's finalizer), autograd-saved tensors included; the peak
of their running sum is the entry's ``peak_hbm_bytes``. Tensors that
existed before the recording (parameters, inputs) are not counted. Unlike
the reference's linear scan over XLA's buffers this is the eager
program's real liveness, so the two packages' peaks are not compared.

**Latency.** :func:`estimate_latency` keeps the reference's overlap model
(every launch site but the last hides under compute); its defaults are an
NVIDIA H100 SXM's datasheet figures instead of the reference's ICI-order
model constants.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Mapping, Optional

#: NVIDIA H100 SXM datasheet figures, the latency model's defaults.
#: NVLink 4: 900 GB/s a GPU, both directions together, so 450 GB/s each
#: way; dense peak rates: fp32 on the CUDA cores, TF32 on the tensor
#: cores split three ways (the flash kernels' 3xTF32 route) and bf16.
H100_NVLINK4_GBPS = 450.0
H100_FP32_FLOPS = 67e12
H100_3XTF32_FLOPS = 494.7e12 / 3
H100_BF16_FLOPS = 989e12

#: The link and compute defaults: NVLink 4's rate, fp32 on the CUDA cores
#: (the port's LM trains in fp32 with TF32 off). The per-launch latency
#: is a model constant, not a datasheet figure: the point is the relative
#: price of a schedule (launch count x latency vs bytes/bandwidth vs
#: overlap), not a wall-clock prophecy.
DEFAULT_LINK_BANDWIDTH_GBPS = H100_NVLINK4_GBPS
DEFAULT_LINK_LATENCY_US = 1.0
DEFAULT_COMPUTE_FLOPS_PER_S = H100_FP32_FLOPS


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Link parameters for one mesh axis: sustained bandwidth (GB/s) and
    per-collective-launch latency (us)."""

    bandwidth_gbps: float = DEFAULT_LINK_BANDWIDTH_GBPS
    latency_us: float = DEFAULT_LINK_LATENCY_US

    @property
    def bytes_per_s(self) -> float:
        return self.bandwidth_gbps * 1e9

    @property
    def latency_s(self) -> float:
        return self.latency_us * 1e-6

    def to_json(self) -> dict:
        return {"bandwidth_gbps": self.bandwidth_gbps,
                "latency_us": self.latency_us}


def parse_mesh_links(spec: str) -> tuple[dict, dict]:
    """``"data=8:90:1.5,model=4"`` -> axis sizes plus per-axis link specs.

    Each axis is ``AXIS=N[:BW_GBPS[:LAT_US]]``; axes without a link suffix
    get the :class:`LinkSpec` defaults. Returns ``(axes, links)`` where
    ``links`` holds only explicitly-specified axes.
    """
    axes: dict[str, int] = {}
    links: dict[str, LinkSpec] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, rest = part.partition("=")
        if not eq or not name.strip():
            raise ValueError(
                f"bad mesh spec {part!r}; expected axis=size (e.g. data=8)")
        fields = rest.split(":")
        if len(fields) > 3:
            raise ValueError(
                f"bad mesh spec {part!r}; expected "
                "AXIS=N[:BW_GBPS[:LAT_US]]")
        size = fields[0]
        try:
            n = int(size)
        except ValueError:
            raise ValueError(
                f"bad mesh axis size {size!r} for axis {name!r}") from None
        if n < 1:
            raise ValueError(f"mesh axis {name!r} must be >= 1, got {n}")
        name = name.strip()
        axes[name] = n
        if len(fields) > 1:
            try:
                bw = float(fields[1])
                lat = (float(fields[2]) if len(fields) > 2
                       else DEFAULT_LINK_LATENCY_US)
            except ValueError:
                raise ValueError(
                    f"bad link spec {rest!r} for axis {name!r}; expected "
                    "N[:BW_GBPS[:LAT_US]]") from None
            if bw <= 0:
                raise ValueError(
                    f"link bandwidth for axis {name!r} must be > 0, got "
                    f"{bw}")
            if lat < 0:
                raise ValueError(
                    f"link latency for axis {name!r} must be >= 0, got "
                    f"{lat}")
            links[name] = LinkSpec(bandwidth_gbps=bw, latency_us=lat)
    return axes, links


def parse_mesh(spec: str) -> dict:
    """``"data=8,model=4"`` -> ``{"data": 8, "model": 4}`` (link suffixes,
    if any, are accepted and dropped — see :func:`parse_mesh_links`)."""
    return parse_mesh_links(spec)[0]


def load_links(path: str) -> tuple[dict, Optional[float]]:
    """Read a link file (``{"links": {axis: {bandwidth_gbps,
    latency_us}}, "flops_per_s": ...}``, the reference's calibration
    format) -> ``(links, flops_per_s)``."""
    import json

    with open(path) as f:
        data = json.load(f)
    links = {
        str(name): LinkSpec(
            bandwidth_gbps=float(spec.get(
                "bandwidth_gbps", DEFAULT_LINK_BANDWIDTH_GBPS)),
            latency_us=float(spec.get(
                "latency_us", DEFAULT_LINK_LATENCY_US)))
        for name, spec in dict(data.get("links", {})).items()}
    flops = data.get("flops_per_s")
    return links, (float(flops) if flops else None)


#: Recorded op names (the ``c10d`` op without its namespace and trailing
#: underscores) by cost family.
_GATHER = ("allgather", "all_gather", "pgather")
_SCATTER = ("reduce_scatter", "psum_scatter", "alltoall", "all_to_all")
_SEND = ("send", "ppermute", "pshuffle")
_FREE = ("recv", "barrier", "pbroadcast", "pvary", "pcast")


def comm_bytes(op: str, payload_bytes: int, axis_size: int) -> int:
    """Per-device bytes on the wire for one launch of ``op`` with a
    per-rank payload of ``payload_bytes`` over ``axis_size`` participants
    (the ring formulas of the module docstring). ``op`` is a recorded
    ``c10d`` op name (``allreduce_``, ``_allgather_base_``,
    ``alltoall_base_``, ``send``, ...) or the reference's primitive name
    (``psum``, ``all_gather``, ``ppermute``, ...)."""
    p = max(int(axis_size), 1)
    name = op.split(".")[1] if op.startswith("c10d.") else op
    if any(f in name for f in _FREE):
        return 0
    if p == 1:
        return 0  # a one-participant collective is a copy at worst
    if any(f in name for f in _GATHER):
        return (p - 1) * payload_bytes
    if any(f in name for f in _SCATTER):
        return int(round((p - 1) / p * payload_bytes))
    if any(f in name for f in _SEND) or "broadcast" in name:
        return payload_bytes
    # all-reduce family: ring all-reduce = reduce-scatter + all-gather.
    return int(round(2 * (p - 1) / p * payload_bytes))


@dataclasses.dataclass(frozen=True)
class CollectiveCost:
    """One collective launch site and its modeled wire cost."""

    op: str
    axes: tuple
    axis_size: int
    payload_bytes: int  # per-rank operand bytes, as recorded
    multiplier: int  # launches of this site in the recorded step
    bytes: int  # comm_bytes(op, payload, axis_size) * multiplier
    shape: tuple
    dtype: str

    def to_json(self) -> dict:
        return {
            "op": self.op, "axes": list(self.axes),
            "axis_size": self.axis_size,
            "payload_bytes": self.payload_bytes,
            "multiplier": self.multiplier, "bytes": self.bytes,
            "shape": list(self.shape), "dtype": self.dtype,
        }


@dataclasses.dataclass(frozen=True)
class LatencyEstimate:
    """Modeled per-step latency for one entry point (the reference's
    overlap model: every launch site but the last hides under compute, as
    far as compute lasts)."""

    compute_s: float
    comm_s: float
    overlapped_s: float
    comm_tail_s: float
    step_latency_s: float
    launches: int
    flops: int

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def estimate_latency(flops: int, collectives: Iterable[CollectiveCost],
                     *, links: Optional[Mapping] = None,
                     flops_per_s: float = DEFAULT_COMPUTE_FLOPS_PER_S,
                     ) -> LatencyEstimate:
    """Price one step: compute from the flop count, comm from per-axis
    link specs (``links`` maps axis name -> :class:`LinkSpec`), each
    launch site ``multiplier * (latency + bytes/bandwidth)``."""
    links = dict(links or {})
    default = LinkSpec()
    compute_s = float(flops) / float(flops_per_s)
    site_times = []
    launches = 0
    for c in collectives:
        link = links.get(c.axes[0], default) if c.axes else default
        mult = max(int(c.multiplier), 1)
        per_launch_bytes = c.bytes / mult
        site_times.append(
            mult * (link.latency_s + per_launch_bytes / link.bytes_per_s))
        launches += mult
    comm_s = float(sum(site_times))
    tail_site_s = float(site_times[-1]) if site_times else 0.0
    overlapped_s = min(comm_s - tail_site_s, compute_s)
    comm_tail_s = comm_s - overlapped_s
    return LatencyEstimate(
        compute_s=compute_s, comm_s=comm_s, overlapped_s=overlapped_s,
        comm_tail_s=comm_tail_s, step_latency_s=compute_s + comm_tail_s,
        launches=launches, flops=int(flops))


@dataclasses.dataclass(frozen=True)
class CostReport:
    """The cost model's verdict for one entry point."""

    entry: str
    collectives: tuple  # of CollectiveCost
    total_comm_bytes: int
    peak_hbm_bytes: int
    mesh: dict  # modeled axis sizes actually applied
    latency: Optional[LatencyEstimate] = None

    def to_json(self) -> dict:
        payload = {
            "entry": self.entry,
            "total_comm_bytes": self.total_comm_bytes,
            "peak_hbm_bytes": self.peak_hbm_bytes,
            "collectives": [c.to_json() for c in self.collectives],
            "mesh": dict(self.mesh),
        }
        if self.latency is not None:
            payload["latency"] = self.latency.to_json()
        return payload


def collect_collective_costs(recording, *,
                             model_mesh: Optional[Mapping] = None) -> list:
    """Price every communication event of one rank's recording, merging
    identical launches into sites in first-launch order."""
    model_mesh = dict(model_mesh or {})
    sites: dict = {}
    for ev in recording.comm_events():
        size = len(ev.group)
        if ev.axis is not None and ev.axis in model_mesh:
            size = int(model_mesh[ev.axis])
        shape, dtype = (ev.shapes[0] if ev.shapes else ((), ""))
        key = (ev.op, ev.axis, size, ev.payload_bytes, shape, dtype)
        count, _ = sites.get(key, (0, None))
        sites[key] = (count + 1, ev)
    out = []
    for (op, axis, size, payload, shape, dtype), (count, _) in \
            sites.items():
        out.append(CollectiveCost(
            op=op, axes=(axis,) if axis else (), axis_size=size,
            payload_bytes=payload, multiplier=count,
            bytes=comm_bytes(op, payload, size) * count,
            shape=tuple(shape), dtype=dtype))
    return out


def peak_live_bytes(recording) -> int:
    """The recording's peak of live tensor bytes (module docstring)."""
    return int(recording.peak_live_bytes)


def analyze_trace(recording, *, entry: str,
                  model_mesh: Optional[Mapping] = None,
                  links: Optional[Mapping] = None,
                  flops_per_s: Optional[float] = None) -> CostReport:
    """The full cost-model verdict for one rank's recording of an entry
    point (the counterpart of the reference's ``analyze_jaxpr``)."""
    colls = collect_collective_costs(recording, model_mesh=model_mesh)
    latency = estimate_latency(
        recording.flops, colls, links=links,
        flops_per_s=(float(flops_per_s) if flops_per_s
                     else DEFAULT_COMPUTE_FLOPS_PER_S))
    return CostReport(
        entry=entry,
        collectives=tuple(colls),
        total_comm_bytes=sum(c.bytes for c in colls),
        peak_hbm_bytes=peak_live_bytes(recording),
        mesh=dict(model_mesh or {}),
        latency=latency,
    )


def matmul_flops(op: str, shapes: list) -> int:
    """FLOPs of one recorded aten op from its input shapes: matmuls and
    convolutions exactly, anything else 0 (the caller adds one flop per
    output element)."""
    name = op.split(".")[1] if op.count(".") >= 2 else op
    try:
        if name in ("mm", "addmm") and len(shapes) >= 2:
            a, b = shapes[-2], shapes[-1]
            return 2 * a[0] * a[1] * b[1]
        if name in ("bmm", "baddbmm") and len(shapes) >= 2:
            a, b = shapes[-2], shapes[-1]
            return 2 * a[0] * a[1] * a[2] * b[2]
        if name in ("convolution", "_convolution") and len(shapes) >= 2:
            x, w = shapes[0], shapes[1]
            spatial = math.prod(x[2:]) if len(x) > 2 else 1
            return 2 * x[0] * spatial * math.prod(w)
    except (IndexError, TypeError):
        return 0
    return 0
