"""Architecture registry core: the ``Architecture`` record + lookup API.

The port's own copy of ``repro/arch/registry.py``.

One registration object carries every capability a fabric can expose.
Capabilities are optional — an ``Architecture`` declares what it supports
and callers introspect with :meth:`Architecture.capabilities` /
:meth:`Architecture.has` to degrade gracefully (e.g. an exact all-to-all
sweep when no translation-symmetry group is available, or skipping a
fabric in a cost table when it declares no cost model).

The capability surface (see ``repro_torch.arch`` package docstring for the
worked registration example):

``flow``
    ``build_flow(**params) -> FlowBuild`` — the fabric at chip
    granularity as a ``core.simulator.FlowNetwork`` plus its chip list,
    in the fabric's natural parameterization.  ``flow_fig14(scale, m,
    k_internal, inj)`` is the normalized entry point every fabric with a
    ``fig14_label`` must honor: a system of ``scale² · m²`` chips, so
    Fig. 14-style throughput sweeps iterate the registry with one shape.
``compiled``
    ``build_compiled(**params) -> CompiledNetwork`` — canonical CSR
    builder; carries a translation-symmetry group when the fabric has
    one (``compiled_fig14`` is the normalized form).
``analytical``
    Closed forms: per-chip all-to-all throughput (paper Eqs. 2-4), the
    All-Reduce time curve (Fig. 15), and the Table 2 row.
``cost``
    ``cost(prices=Prices(), **params) -> CostRow`` plus
    ``cost_variants`` — the (ordered) concrete rows the fabric
    contributes to Table 6.
``routing``
    Minimal / non-minimal next-hop routing (paper §4.1).
``ring_orders``
    OCS circuit synthesis: per-switch node ring orders realizing the
    fabric on the RailX hardware (``core.topology.configure_rails``).
``job_network``
    ``job_network(cfg, mapping, alloc) -> FlowNetwork`` — the
    node-granularity flow network of one scheduled job's reconfigured
    rails (used by ``cluster.metrics.estimate_goodput``).
``adj``
    ``build_adj(**params) -> AdjGraph`` — node-level adjacency dict
    (``core.topology`` graph utilities).
"""

from __future__ import annotations

import dataclasses
from typing import (
    Callable,
    Dict,
    Iterator,
    List,
    Mapping,
    Optional,
    Tuple,
)

from ..core.simulator import FlowNetwork, Vertex


@dataclasses.dataclass(frozen=True)
class FlowBuild:
    """A chip-granularity flow network plus the chip vertices to sweep."""

    net: FlowNetwork
    chips: List[Vertex]


@dataclasses.dataclass(frozen=True)
class Table2Entry:
    """One row of the Table 2 scalability/diameter/bisection summary."""

    key: str                                   # dict key in table2_metrics
    order: int                                 # row position (ascending)
    row: Callable[..., Dict[str, float]]       # RailXConfig -> metrics dict


@dataclasses.dataclass(frozen=True)
class AnalyticalForms:
    """Closed-form capability bundle (all members optional)."""

    # RailXConfig -> per-chip all-to-all throughput in per-port units
    # (paper Eqs. 2-4)
    alltoall_per_chip: Optional[Callable[..., float]] = None
    # (m, p, V, nB, alpha, k=..., alpha_int=...) -> seconds (Fig. 15)
    allreduce_time: Optional[Callable[..., float]] = None
    table2: Optional[Table2Entry] = None


@dataclasses.dataclass(frozen=True)
class CostVariant:
    """One concrete Table 6 row contributed by an architecture.

    ``order`` fixes the row's position in the assembled table: the seed
    rows keep the paper's ordering, registry extensions sort after them.
    """

    order: int
    build: Callable[..., object]               # Prices -> CostRow


@dataclasses.dataclass(frozen=True)
class RoutingSupport:
    """Next-hop routing capability (paper §4.1 Algorithm 1 + §4.1.2)."""

    topology: str                              # RoutingParams.topology value
    minimal: Callable[..., list]               # (params, src, dst) -> [Hop]
    nonminimal: Optional[Callable[..., list]] = None

    def params(self, m: int, scale_x: int, scale_y: int):
        from ..core.routing import RoutingParams

        return RoutingParams(
            m=m, scale_x=scale_x, scale_y=scale_y, topology=self.topology
        )


@dataclasses.dataclass(frozen=True)
class Architecture:
    """One network fabric and everything this repo knows how to do with it."""

    name: str
    description: str
    paper: str = ""

    # flow capability
    build_flow: Optional[Callable[..., FlowBuild]] = None
    flow_fig14: Optional[Callable[[int, int, float, float], FlowBuild]] = None
    fig14_label: Optional[str] = None          # row label in Fig. 14 sweeps
    fig14_order: int = 0

    # compiled (canonical CSR) capability
    build_compiled: Optional[Callable[..., object]] = None
    compiled_fig14: Optional[Callable[[int, int, float], object]] = None

    analytical: Optional[AnalyticalForms] = None

    # cost capability
    cost: Optional[Callable[..., object]] = None
    cost_variants: Tuple[CostVariant, ...] = ()

    routing: Optional[RoutingSupport] = None
    ring_orders: Optional[Callable[..., Dict]] = None
    job_network: Optional[Callable[..., FlowNetwork]] = None
    build_adj: Optional[Callable[..., Dict]] = None

    def capabilities(self) -> Tuple[str, ...]:
        """The declared capability names, in a stable order."""
        caps = []
        if self.build_flow is not None:
            caps.append("flow")
        if self.build_compiled is not None:
            caps.append("compiled")
        if self.analytical is not None:
            caps.append("analytical")
        if self.cost is not None or self.cost_variants:
            caps.append("cost")
        if self.routing is not None:
            caps.append("routing")
        if self.ring_orders is not None:
            caps.append("ring_orders")
        if self.job_network is not None:
            caps.append("job_network")
        if self.build_adj is not None:
            caps.append("adj")
        return tuple(caps)

    def has(self, cap: str) -> bool:
        return cap in self.capabilities()

    def require(self, cap: str) -> "Architecture":
        if not self.has(cap):
            raise KeyError(
                f"architecture {self.name!r} does not declare the {cap!r} "
                f"capability (has: {', '.join(self.capabilities()) or 'none'})"
            )
        return self


class ArchitectureRegistry(Mapping):
    """Name -> ``Architecture`` mapping preserving registration order."""

    def __init__(self) -> None:
        self._archs: Dict[str, Architecture] = {}

    def register(self, arch: Architecture) -> Architecture:
        if arch.name in self._archs:
            raise ValueError(f"architecture {arch.name!r} already registered")
        if arch.fig14_label is not None and arch.flow_fig14 is None:
            raise ValueError(
                f"{arch.name!r} declares fig14_label without flow_fig14"
            )
        self._archs[arch.name] = arch
        return arch

    def __getitem__(self, name: str) -> Architecture:
        try:
            return self._archs[name]
        except KeyError:
            raise KeyError(
                f"unknown architecture {name!r}; registered: "
                f"{', '.join(self._archs) or 'none'}"
            ) from None

    def __iter__(self) -> Iterator[str]:
        return iter(self._archs)

    def __len__(self) -> int:
        return len(self._archs)

    def with_capability(self, cap: str) -> List[Architecture]:
        return [a for a in self._archs.values() if a.has(cap)]


registry = ArchitectureRegistry()


def register(arch: Architecture) -> Architecture:
    return registry.register(arch)


def get(name: str) -> Architecture:
    return registry[name]


def names() -> List[str]:
    return list(registry)


def fig14_archs() -> List[Architecture]:
    """Architectures participating in the normalized Fig. 14 sweep, in
    row order (seed curves first, registry extensions after)."""
    archs = [a for a in registry.values() if a.fig14_label is not None]
    archs.sort(key=lambda a: a.fig14_order)
    return archs
