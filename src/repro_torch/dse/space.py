"""Declarative multi-chiplet design-space definition (repro_torch.dse).

The counterpart of ``repro.dse.space``: the same space, candidates,
total order and neighbourhood (``sample``/``mutate``/``crossover`` take a
numpy ``Generator`` and stay on the host), and an encoder whose tables
are tensors, so that a chunk of candidate indices lowers to a
:class:`~repro_torch.core.batch.SystemBatch` on the device.

A :class:`DesignSpace` describes a *product portfolio* — the SKUs a
vendor ships, each with a module inventory (total functional area) and a
production volume — together with the architectural freedoms the search
may exercise: allowed process nodes, integration technologies, chiplet
counts, and cross-SKU chiplet-reuse (the paper's SCMS scheme generalized
to arbitrary per-SKU socket counts via
:func:`repro_torch.core.reuse.portfolio_reuse_systems`).

A :class:`Candidate` is one fully concrete point of that space: either a
per-SKU tuple of :class:`ArchChoice` (independent architectures) or a
:class:`ReuseChoice` (one shared chiplet design collocated across the
whole portfolio).  ``candidate_systems`` lowers a candidate to the
:class:`~repro_torch.core.system.System` group that
:class:`~repro_torch.core.batch.SystemBatch` packs and the engine prices.

The space is countable: ``size()`` / ``candidate_at(i)`` give a total
order, so exhaustive enumeration, uniform sampling and index-based
decoding all agree — the property the seeded-determinism tests pin.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.batch import SystemBatch
from ..core.engine import NREBreakdown
from ..core.reuse import portfolio_reuse_systems
from ..core.system import System, spec
from ..core.technology import node, tech

_REL_TOL = 1e-6


@dataclasses.dataclass(frozen=True)
class SKU:
    """One product in the portfolio: a module inventory and its volume."""

    name: str
    module_area_mm2: float
    quantity: float


@dataclasses.dataclass(frozen=True)
class ArchChoice:
    """Architecture of a single SKU: ``n_chiplets`` even slices of the
    module area on ``process``, packaged with ``integration``.

    ``n_chiplets == 1`` always means the monolithic SoC baseline
    (integration "SoC", no D2D overhead), as in the paper's Fig. 4.
    """

    n_chiplets: int
    process: str
    integration: str

    def label(self) -> str:
        if self.n_chiplets == 1:
            return f"soc/{self.process}"
        return f"{self.n_chiplets}x/{self.process}/{self.integration}"


@dataclasses.dataclass(frozen=True)
class ReuseChoice:
    """One shared chiplet design across the whole portfolio (SCMS-style):
    every SKU is ``round(area / slice_area_mm2)`` copies of the slice."""

    slice_area_mm2: float
    process: str
    integration: str
    package_reuse: bool = False

    def label(self) -> str:
        pkg = "+pkg" if self.package_reuse else ""
        return (f"reuse[{self.slice_area_mm2:g}mm2/{self.process}"
                f"/{self.integration}{pkg}]")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One concrete portfolio architecture (hashable — search dedup key)."""

    choices: Tuple[ArchChoice, ...] = ()
    reuse: Optional[ReuseChoice] = None

    def __post_init__(self):
        if (self.reuse is None) == (not self.choices):
            raise ValueError("candidate needs choices xor a reuse scheme")

    @property
    def is_reuse(self) -> bool:
        return self.reuse is not None

    def label(self) -> str:
        if self.reuse is not None:
            return self.reuse.label()
        return " | ".join(c.label() for c in self.choices)


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """The searchable portfolio design space.

    ``chiplet_counts`` containing 1 enables the monolithic-SoC option per
    SKU; counts > 1 combine with every (process, integration) pair.
    ``allow_reuse`` adds SCMS-style candidates whose slice areas are
    derived from the SKU areas (a slice is valid iff every SKU area is an
    in-range integer multiple of it).  ``reuse_within_sku`` gives the
    slices of one non-reuse split a single design name (chiplet NRE paid
    once per SKU); the paper's Fig. 4 no-reuse assumption is
    ``reuse_within_sku=False``.
    """

    skus: Tuple[SKU, ...]
    processes: Tuple[str, ...] = ("7nm",)
    integrations: Tuple[str, ...] = ("MCM",)
    chiplet_counts: Tuple[int, ...] = (1, 2, 3, 4)
    allow_reuse: bool = True
    reuse_package_options: Tuple[bool, ...] = (False,)
    reuse_within_sku: bool = True

    def __post_init__(self):
        if not self.skus:
            raise ValueError("design space needs at least one SKU")
        names = [s.name for s in self.skus]
        if len(set(names)) != len(names):
            raise ValueError("SKU names must be unique")
        if not self.processes:
            raise ValueError("design space needs at least one process node")
        if not self.integrations and max(self.chiplet_counts) > 1:
            raise ValueError(
                "chiplet counts > 1 need at least one integration tech")
        for p in self.processes:
            node(p)
        for t in self.integrations:
            if t == "SoC":
                raise ValueError(
                    "integrations are multi-chip technologies; the SoC "
                    "baseline is the n_chiplets=1 option")
            tech(t)
        if not self.chiplet_counts or min(self.chiplet_counts) < 1:
            raise ValueError("chiplet_counts must be positive")

    # -- choice inventories (cached: the space is frozen, and the search
    # loop asks for them on every sample/mutate/crossover) -------------------
    @functools.cached_property
    def _arch_choices(self) -> Tuple[ArchChoice, ...]:
        out = []
        if 1 in self.chiplet_counts:
            out += [ArchChoice(1, p, "SoC") for p in self.processes]
        out += [ArchChoice(n, p, t)
                for n in sorted(set(self.chiplet_counts)) if n > 1
                for p in self.processes for t in self.integrations]
        return tuple(out)

    @functools.cached_property
    def _reuse_choices(self) -> Tuple[ReuseChoice, ...]:
        if not self.allow_reuse:
            return ()
        return tuple(ReuseChoice(a, p, t, pkg)
                     for a in self.reuse_slice_areas()
                     for p in self.processes for t in self.integrations
                     for pkg in self.reuse_package_options)

    def arch_choices(self) -> List[ArchChoice]:
        """Per-SKU architecture options (same menu for every SKU)."""
        return list(self._arch_choices)

    def reuse_slice_areas(self) -> List[float]:
        """Slice areas under which every SKU is an in-range integer
        multiple — the valid cross-SKU reuse granularities."""
        counts = sorted(set(self.chiplet_counts))
        cands = sorted({s.module_area_mm2 / n
                        for s in self.skus for n in counts}, reverse=True)
        out: List[float] = []
        for a in cands:
            ok = True
            for s in self.skus:
                k = s.module_area_mm2 / a
                if abs(k - round(k)) > _REL_TOL * max(k, 1.0) \
                        or int(round(k)) not in counts:
                    ok = False
                    break
            if ok and not any(abs(a - b) <= _REL_TOL * a for b in out):
                out.append(a)
        return out

    def reuse_choices(self) -> List[ReuseChoice]:
        return list(self._reuse_choices)

    def reuse_counts(self, r: ReuseChoice) -> Tuple[int, ...]:
        """Per-SKU socket counts under ``r`` — rejects a slice that does
        not implement the SKU inventories (wrong area or out-of-range
        count), so foreign/hand-built reuse candidates cannot be silently
        lowered to the wrong silicon."""
        counts = []
        for s in self.skus:
            k = s.module_area_mm2 / r.slice_area_mm2
            if abs(k - round(k)) > _REL_TOL * max(k, 1.0) \
                    or int(round(k)) not in self.chiplet_counts:
                raise ValueError(
                    f"slice {r.slice_area_mm2:g} mm^2 does not tile SKU "
                    f"{s.name!r} ({s.module_area_mm2:g} mm^2) within the "
                    f"allowed chiplet counts {self.chiplet_counts}")
            counts.append(int(round(k)))
        return tuple(counts)

    # -- countable enumeration ----------------------------------------------
    def size(self) -> int:
        return (len(self._arch_choices) ** len(self.skus)
                + len(self._reuse_choices))

    def candidate_at(self, i: int) -> Candidate:
        """Decode index ``i`` (0 <= i < size()) into a candidate."""
        arch = self._arch_choices
        n_arch = len(arch) ** len(self.skus)
        if i < 0 or i >= self.size():
            raise IndexError(f"candidate index {i} out of range")
        if i < n_arch:
            # match enumerate_candidates(): SKU 0 is the most significant
            # digit of the mixed-radix index
            digits = []
            for _ in self.skus:
                i, d = divmod(i, len(arch))
                digits.append(arch[d])
            return Candidate(choices=tuple(reversed(digits)))
        return Candidate(reuse=self._reuse_choices[i - n_arch])

    def enumerate_candidates(self) -> Iterator[Candidate]:
        for combo in itertools.product(self._arch_choices,
                                       repeat=len(self.skus)):
            yield Candidate(choices=combo)
        for r in self._reuse_choices:
            yield Candidate(reuse=r)

    def sample(self, rng: np.random.Generator, n: int) -> List[Candidate]:
        """Uniform-with-replacement sample of ``n`` candidates."""
        return [self.candidate_at(int(i))
                for i in rng.integers(0, self.size(), size=n)]

    # -- search neighborhood -------------------------------------------------
    def mutate(self, rng: np.random.Generator, cand: Candidate,
               jump_prob: float = 0.15) -> Candidate:
        """A random neighbor: tweak one SKU's choice (or hop between the
        reuse and independent families); occasionally jump anywhere."""
        if rng.random() < jump_prob:
            return self.candidate_at(int(rng.integers(0, self.size())))
        reuse = self._reuse_choices
        if cand.is_reuse:
            if len(reuse) > 1 and rng.random() < 0.7:
                others = [r for r in reuse if r != cand.reuse]
                return Candidate(reuse=others[int(rng.integers(len(others)))])
            return self.candidate_at(
                int(rng.integers(0, len(self._arch_choices)
                                 ** len(self.skus))))
        arch = self._arch_choices
        if reuse and rng.random() < 0.15:
            return Candidate(reuse=reuse[int(rng.integers(len(reuse)))])
        i = int(rng.integers(len(self.skus)))
        others = [a for a in arch if a != cand.choices[i]]
        if not others:
            return cand
        new = list(cand.choices)
        new[i] = others[int(rng.integers(len(others)))]
        return Candidate(choices=tuple(new))

    def crossover(self, rng: np.random.Generator, a: Candidate,
                  b: Candidate) -> Candidate:
        """Per-SKU uniform crossover; reuse candidates fall back to
        mutation (they have no per-SKU genes)."""
        if a.is_reuse or b.is_reuse:
            return self.mutate(rng, a)
        picks = rng.integers(0, 2, size=len(self.skus))
        return Candidate(choices=tuple(
            (a if p == 0 else b).choices[i] for i, p in enumerate(picks)))

    # -- batching bounds -----------------------------------------------------
    def max_chips(self) -> int:
        """Widest system any candidate can produce (padding bound)."""
        m = max(self.chiplet_counts)
        for r in self._reuse_choices:
            m = max(m, max(self.reuse_counts(r)))
        return m

    # -- index algebra (inverse of candidate_at) ----------------------------
    @functools.cached_property
    def _arch_index(self) -> Dict[ArchChoice, int]:
        return {a: i for i, a in enumerate(self._arch_choices)}

    @functools.cached_property
    def _reuse_index(self) -> Dict[ReuseChoice, int]:
        return {r: i for i, r in enumerate(self._reuse_choices)}

    def index_of(self, cand: Candidate) -> int:
        """The unique index with ``candidate_at(index_of(c)) == c`` — the
        bridge from candidate objects to the array-native fused pipeline."""
        try:
            if cand.reuse is not None:
                return (len(self._arch_choices) ** len(self.skus)
                        + self._reuse_index[cand.reuse])
            if len(cand.choices) != len(self.skus):
                raise KeyError(cand)
            i = 0
            base = len(self._arch_choices)
            for c in cand.choices:       # SKU 0 is the most significant digit
                i = i * base + self._arch_index[c]
            return i
        except KeyError:
            raise ValueError(
                f"candidate {cand.label()} is not a member of this "
                "design space") from None

    def encoder(self) -> "CandidateEncoder":
        """The cached vectorized candidate encoder for this space."""
        return self._encoder

    @functools.cached_property
    def _encoder(self) -> "CandidateEncoder":
        return CandidateEncoder(self)


def candidate_systems(space: DesignSpace, cand: Candidate) -> List[System]:
    """Lower one candidate to its per-SKU :class:`System` group.

    The group is meant to be priced with NRE shared *within* the
    candidate (one ``share_nre`` group): reuse candidates then amortize
    the single chiplet design over the whole portfolio volume.
    """
    if cand.choices and len(cand.choices) != len(space.skus):
        raise ValueError(
            f"candidate has {len(cand.choices)} per-SKU choices but the "
            f"space has {len(space.skus)} SKUs")
    if cand.reuse is not None:
        r = cand.reuse
        return portfolio_reuse_systems(
            r.slice_area_mm2, r.process, r.integration,
            counts=list(space.reuse_counts(r)),
            quantities=[s.quantity for s in space.skus],
            names=[s.name for s in space.skus],
            package_reuse=r.package_reuse)
    out = []
    for sku, c in zip(space.skus, cand.choices):
        if c.n_chiplets == 1:
            out.append(spec({"kind": "soc", "name": sku.name,
                             "area": sku.module_area_mm2,
                             "process": c.process,
                             "quantity": sku.quantity}))
        else:
            out.append(spec({"kind": "split", "name": sku.name,
                             "area": sku.module_area_mm2,
                             "process": c.process, "n": c.n_chiplets,
                             "integration": c.integration,
                             "quantity": sku.quantity,
                             "reuse_chiplet": space.reuse_within_sku}))
    return out


# ---------------------------------------------------------------------------
# Vectorized candidate encoder — the on-device half of candidate_systems.
# ---------------------------------------------------------------------------

# Per-(SKU, extended choice) float tables the encoder gathers from.  Every
# value is read off the *actual* System objects candidate_systems builds
# (same float64 -> float32 cast as SystemBatch.from_systems), so the
# encoded batch is bit-identical to the host-packed one.
_CHOICE_TABLE_FIELDS = (
    # chip slots
    "n_chips", "chip_area", "mod_area", "chip_defect", "wafer_cost",
    "cluster", "wafer_yield", "sort_cost", "bump_cost",
    # chip/module NRE coefficients
    "nre_chip_k", "nre_chip_fixed", "nre_mod_k",
    # D2D interface
    "has_d2d", "d2d_pidx",
    # per-system / package
    "package_area", "package_area_factor", "substrate_cost",
    "substrate_layer", "interposer_cost", "interposer_defect",
    "interposer_area_factor", "interposer_cluster", "y2_chip_bond",
    "y3_substrate_bond", "assembly_yield", "bond_cost_per_chip",
    "pkg_k", "pkg_fixed",
)


@dataclasses.dataclass(frozen=True)
class EncoderMeta:
    """Static (hashable) geometry of a space's encoder: the shapes every
    encoded chunk of the space shares."""

    n_skus: int
    max_chips: int
    n_arch_choices: int      # A: per-SKU architecture menu size
    n_reuse_choices: int     # R: cross-SKU reuse candidates
    n_processes: int         # P: D2D entity namespace width per candidate
    n_arch: int              # A ** n_skus (first reuse index)
    size: int                # total candidate count
    reuse_within_sku: bool


class CandidateEncoder:
    """Pure-tensor lowering of candidate *indices* to a :class:`SystemBatch`.

    Construction walks every (SKU, architecture choice) and every reuse
    choice ONCE through :func:`candidate_systems` (the parity oracle) and
    records the resulting per-system / per-chip floats in dense
    ``(S, A + R)`` host tables.  :meth:`tables_on` copies them to a device
    once; :meth:`encode` is then pure torch: decoding a ``(K,)`` index
    vector into a padded, NRE-grouped ``(K * S)``-system batch is all
    gathers and broadcasts on the indices' device, with no per-candidate
    Python and no read back to the host.

    The NRE entity layout is canonical rather than discovery-ordered:
    candidate ``j`` owns chip/module entity rows ``1 + j*S*C .. ``,
    package rows ``1 + j*S ..`` and D2D rows ``1 + j*P ..`` (row 0 of
    every table is a shared zero-NRE sink for padded slots).  Shapes
    match :func:`repro_torch.dse.evaluate.chunk_shape` exactly.
    """

    def __init__(self, space: DesignSpace):
        if space.size() > np.iinfo(np.int32).max:
            raise ValueError(
                f"space has {space.size()} candidates; the int32 index "
                "encoding supports at most 2**31 - 1")
        self.space = space
        s, c = len(space.skus), space.max_chips()
        a, r = len(space._arch_choices), len(space._reuse_choices)
        p = len(space.processes)
        self.meta = EncoderMeta(
            n_skus=s, max_chips=c, n_arch_choices=a, n_reuse_choices=r,
            n_processes=p, n_arch=a ** s, size=space.size(),
            reuse_within_sku=space.reuse_within_sku)

        tab = {f: np.zeros((s, a + r), np.float32)
               for f in _CHOICE_TABLE_FIELDS}
        pkg_shared = np.zeros((a + r,), np.float32)
        for e in range(a + r):
            if e < a:
                cand = Candidate(choices=(space._arch_choices[e],) * s)
            else:
                ch = space._reuse_choices[e - a]
                pkg_shared[e] = 1.0 if ch.package_reuse else 0.0
                cand = Candidate(reuse=ch)
            for i, sys in enumerate(candidate_systems(space, cand)):
                self._fill(tab, i, e, sys)
        tab["pkg_shared"] = pkg_shared
        # static per-process D2D NRE menu (row values are candidate-free)
        tab["d2d_nre"] = np.asarray(
            [node(p_).nre_d2d for p_ in space.processes], np.float32)
        tab["quantity"] = np.asarray(
            [sk.quantity for sk in space.skus], np.float32)
        # mixed-radix digit extractors, SKU 0 most significant
        tab["digit_pow"] = np.asarray(
            [a ** (s - 1 - i) for i in range(s)], np.int32)
        self.host_tables: Dict[str, np.ndarray] = tab
        self._on: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def tables_on(self, device) -> Dict[str, torch.Tensor]:
        """The tables as tensors on ``device``, copied there once."""
        dev = torch.device(device)
        if dev not in self._on:
            self._on[dev] = {k: torch.as_tensor(v, device=dev)
                             for k, v in self.host_tables.items()}
        return self._on[dev]

    def _fill(self, tab, i: int, e: int, sys: System):
        chip = sys.chips[0]
        for other in sys.chips[1:]:     # even slices / reuse copies only
            if (other.area_mm2 != chip.area_mm2
                    or other.process != chip.process):
                raise ValueError(
                    f"encoder requires homogeneous chips per system; "
                    f"{sys.name} mixes designs")
        nd, t = chip.node, sys.tech
        d2d = [m for m in chip.modules if m.is_d2d]
        v = {
            "n_chips": sys.n_chips, "chip_area": chip.area_mm2,
            "mod_area": chip.module_area_mm2,
            "chip_defect": chip.defect_density,
            "wafer_cost": nd.wafer_cost, "cluster": nd.cluster_param,
            "wafer_yield": nd.wafer_yield, "sort_cost": nd.wafer_sort_cost,
            "bump_cost": nd.bump_cost_per_mm2,
            "nre_chip_k": nd.nre_chip_per_mm2,
            "nre_chip_fixed": nd.nre_fixed_per_chip,
            "nre_mod_k": nd.nre_module_per_mm2,
            "has_d2d": 1.0 if d2d else 0.0,
            "d2d_pidx": (self.space.processes.index(chip.process)
                         if d2d else 0),
            "package_area": sys.package_area,
            "package_area_factor": t.package_area_factor,
            "substrate_cost": t.substrate_cost_per_mm2,
            "substrate_layer": t.substrate_layer_factor,
            "interposer_cost": t.interposer_cost_per_mm2,
            "interposer_defect": t.interposer_defect_density,
            "interposer_area_factor": t.interposer_area_factor,
            "interposer_cluster": node(t.interposer_node).cluster_param,
            "y2_chip_bond": t.y2_chip_bond,
            "y3_substrate_bond": t.y3_substrate_bond,
            "assembly_yield": t.assembly_yield,
            "bond_cost_per_chip": t.bond_cost_per_chip,
            "pkg_k": t.nre_package_per_mm2,
            "pkg_fixed": t.nre_fixed_per_package,
        }
        for k, val in v.items():
            tab[k][i, e] = val

    def encode(self, idx: torch.Tensor) -> SystemBatch:
        """Lower a ``(K,)`` int tensor of candidate indices to a padded
        ``SystemBatch`` (one NRE group per candidate) on its device."""
        return encode_arrays(self.tables_on(idx.device), self.meta, idx)


def _decode(tables: Dict[str, torch.Tensor], meta: EncoderMeta, idx):
    """Shared index decode: (K,) indices -> (is_reuse (K,), ext (K, S))
    where ``ext`` is each SKU's extended-choice column (arch digit, or
    ``A + r`` for reuse candidates), int64 for gathers."""
    a = meta.n_arch_choices
    idx = idx.to(torch.int32)
    is_reuse = idx >= meta.n_arch                                    # (K,)
    arch_i = torch.where(is_reuse, 0, idx)
    digits = (arch_i[:, None] // tables["digit_pow"][None, :]) % a   # (K,S)
    r = torch.where(is_reuse, idx - meta.n_arch, 0)
    ext = torch.where(is_reuse[:, None], a + r[:, None], digits)     # (K,S)
    return is_reuse, ext.long()


def encode_arrays(tables: Dict[str, torch.Tensor], meta: EncoderMeta,
                  idx: torch.Tensor) -> SystemBatch:
    """Pure-tensor candidate decode (see :class:`CandidateEncoder`), on
    the device of ``idx`` and ``tables``.

    Out-of-range indices are the caller's to refuse (``candidate_at``'s
    host-side range check), as in the reference.
    """
    s, c, p = meta.n_skus, meta.max_chips, meta.n_processes
    is_reuse, ext = _decode(tables, meta, idx)
    dev = ext.device
    k = ext.shape[0]
    n = k * s

    srange = torch.arange(s, device=dev)

    def g(name):
        """(K, S) per-system gather, flattened to (N,)."""
        return tables[name][srange[None, :], ext].reshape(n)

    n_chips = g("n_chips")
    mask = (torch.arange(c, dtype=torch.float32, device=dev)[None, :]
            < n_chips[:, None]).to(torch.float32)                    # (N,C)

    def chip(name, pad=0.0):
        val = g(name)[:, None] * mask
        return val if pad == 0.0 else val + pad * (1.0 - mask)

    # -- canonical NRE entity layout (see class docstring) -----------------
    sys_i = torch.arange(n, dtype=torch.int32, device=dev)
    cand_of_sys = sys_i // s
    is_reuse_sys = torch.repeat_interleave(is_reuse, s)
    slot = torch.arange(c, dtype=torch.int32, device=dev)[None, :]
    own_row = 1 + (sys_i * c)[:, None] + slot                        # (N,C)
    sku_row = 1 + (sys_i * c)[:, None] + 0 * slot
    cand_row = 1 + (cand_of_sys * (s * c))[:, None] + 0 * slot
    arch_row = sku_row if meta.reuse_within_sku else own_row
    chip_ids = torch.where(mask > 0.0,
                           torch.where(is_reuse_sys[:, None], cand_row,
                                       arch_row), 0).to(torch.int32)

    zero1 = torch.zeros((1,), dtype=torch.float32, device=dev)

    def ent(values_2d):
        """Prefix a zero sink row and flatten (N, C) slot values."""
        return torch.cat([zero1, values_2d.reshape(-1)])

    pkg_shared = tables["pkg_shared"][ext[:, 0]] > 0.0               # (K,)
    pkg_shared_sys = torch.repeat_interleave(pkg_shared, s)
    pkg_ids = torch.where(pkg_shared_sys, 1 + cand_of_sys * s,
                          1 + sys_i).to(torch.int32)

    inst_sys = torch.repeat_interleave(sys_i, c)                     # (N*C,)
    has_d2d = (g("has_d2d")[:, None] * mask) > 0.0
    d2d_ids = torch.where(
        has_d2d,
        1 + (cand_of_sys * p)[:, None]
        + g("d2d_pidx").to(torch.int32)[:, None] + 0 * slot,
        0).to(torch.int32)

    quantity = tables["quantity"].repeat(k)
    return SystemBatch.from_arrays(
        device=dev,
        chip_area=chip("chip_area"),
        chip_defect=chip("chip_defect"),
        chip_wafer_cost=chip("wafer_cost"),
        chip_cluster=chip("cluster", pad=1.0),
        chip_wafer_yield=chip("wafer_yield", pad=1.0),
        chip_sort_cost=chip("sort_cost"),
        chip_bump_cost=chip("bump_cost"),
        chip_mask=mask,
        package_area=g("package_area"),
        package_area_factor=g("package_area_factor"),
        substrate_cost=g("substrate_cost"),
        substrate_layer=g("substrate_layer"),
        interposer_cost=g("interposer_cost"),
        interposer_defect=g("interposer_defect"),
        interposer_area_factor=g("interposer_area_factor"),
        interposer_cluster=g("interposer_cluster"),
        y2_chip_bond=g("y2_chip_bond"),
        y3_substrate_bond=g("y3_substrate_bond"),
        assembly_yield=g("assembly_yield"),
        bond_cost_per_chip=g("bond_cost_per_chip"),
        quantity=quantity,
        chip_entity_id=chip_ids,
        chip_entity_area=ent(chip("chip_area")),
        chip_entity_k=ent(chip("nre_chip_k")),
        chip_entity_fixed=ent(chip("nre_chip_fixed")),
        pkg_entity_id=pkg_ids,
        pkg_entity_area=torch.cat([zero1, g("package_area")]),
        pkg_entity_k=torch.cat([zero1, g("pkg_k")]),
        pkg_entity_fixed=torch.cat([zero1, g("pkg_fixed")]),
        mod_sys=inst_sys,
        mod_entity=chip_ids.reshape(-1),
        mod_entity_area=ent(chip("mod_area")),
        mod_entity_k=ent(chip("nre_mod_k")),
        d2d_sys=inst_sys,
        d2d_entity=d2d_ids.reshape(-1),
        d2d_entity_nre=torch.cat([zero1, tables["d2d_nre"].repeat(k)]),
    )


def encode_batch(space: DesignSpace, idx, device=None) -> SystemBatch:
    """Vectorized ``candidate_at`` + ``candidate_systems`` + packing: turn
    a ``(K,)`` vector of candidate indices into the padded, NRE-grouped
    :class:`SystemBatch` the engine prices, entirely in tensor ops.  A
    tensor ``idx`` is encoded on its device; anything else goes to
    ``device`` (the GPU unless the caller names another)."""
    if not isinstance(idx, torch.Tensor):
        idx = torch.as_tensor(np.asarray(idx, np.int32),
                              device=resolve_device(device))
    return space.encoder().encode(idx)


def encoded_nre(tables: Dict[str, torch.Tensor], meta: EncoderMeta,
                idx: torch.Tensor) -> NREBreakdown:
    """Closed-form per-unit NRE for encoder-canonical candidate batches.

    The generic engine amortizes design entities with segment sums —
    correct for arbitrary batches.  The encoder's canonical layout makes
    every Eq. (6)-(8) denominator *closed-form*:

    * within-SKU sharing: the SKU's ``n`` chips (and module instances)
      share one design over ``q * n`` uses -> per-unit ``NRE_e / q``
      (``reuse_within_sku=False``: ``n`` distinct designs, ``n*NRE_e/q``);
    * cross-SKU reuse: one design over ``sum_s q_s * n_s`` uses;
    * packages: own design over ``q`` (shared: over ``sum_s q_s``);
    * D2D: one interface per (candidate, process) over the
      ``q_s * n_s`` of the SKUs that use it (a one-hot reduce over the
      P-wide process menu, not a scatter).

    Returns the engine's :class:`~repro_torch.core.engine.NREBreakdown`
    with ``(K * S,)`` fields, matching ``CostEngine.nre`` on the same
    encoded batch to float32 rounding — the fused pipeline's NRE stage.
    """
    s, p = meta.n_skus, meta.n_processes
    eps = 1e-30
    is_reuse, ext = _decode(tables, meta, idx)
    dev = ext.device
    k = ext.shape[0]
    srange = torch.arange(s, device=dev)

    def g(name):                                     # (K, S) gathers
        return tables[name][srange[None, :], ext]

    q = tables["quantity"][None, :].expand(k, s)
    n = g("n_chips")
    reuse_col = is_reuse[:, None]

    # chip + module designs (Eq. 7/8)
    chip_nre = g("nre_chip_k") * g("chip_area") + g("nre_chip_fixed")
    mod_nre = g("nre_mod_k") * g("mod_area")
    denom_c = (q * n).sum(-1, keepdim=True).clamp_min(eps)
    mult = 1.0 if meta.reuse_within_sku else n
    chips = torch.where(reuse_col, n * chip_nre / denom_c,
                        mult * chip_nre / q.clamp_min(eps))
    modules = torch.where(reuse_col, n * mod_nre / denom_c,
                          mult * mod_nre / q.clamp_min(eps))

    # package designs: own per system unless the reuse scheme shares one
    pkg_nre = g("pkg_k") * g("package_area") + g("pkg_fixed")
    shared = tables["pkg_shared"][ext] > 0.0
    denom_p = q.sum(-1, keepdim=True).clamp_min(eps)
    packages = torch.where(shared, pkg_nre / denom_p,
                           pkg_nre / q.clamp_min(eps))

    # D2D interfaces: one per (candidate, process) across the candidate
    has = g("has_d2d")
    pidx = g("d2d_pidx").long()
    w = has * q * n                                          # (K, S) uses
    onehot = pidx[:, :, None] == torch.arange(p, device=dev)[None, None, :]
    denom_d = (w[:, :, None] * onehot).sum(1)                # (K, P)
    den_sys = torch.take_along_dim(denom_d, pidx, dim=1)     # (K, S)
    d2d = has * n * tables["d2d_nre"][pidx] / den_sys.clamp_min(eps)

    flat = k * s
    return NREBreakdown(modules=modules.reshape(flat),
                        chips=chips.reshape(flat),
                        packages=packages.reshape(flat),
                        d2d=d2d.reshape(flat))
