"""Batched struct-of-arrays representation of heterogeneous systems.

:class:`SystemBatch` encodes N *arbitrary* systems (mixed nodes, unequal
chip areas, different integration technologies, package reuse) as a
dataclass of tensors, padded to ``max_chips`` chips per system.  It is
the input type of :class:`repro_torch.core.engine.CostEngine`, which
evaluates the paper's full RE + NRE model (Eqs. 4-8) for the whole batch
on the batch's device.

Construction happens host-side: ``from_systems`` / ``from_specs`` pack
numpy arrays and copy each leaf to the device once.  The constructors
take ``device=None``, which means the GPU (``repro_torch.resolve_device``
raises without one); pass ``device="cpu"`` to price on the CPU.  Float
leaves are float32 and ids int32.  Any leaf may be swapped
(:meth:`SystemBatch.replace`) for a tensor that requires grad, which is
how the partitioner differentiates areas without rebuilding the batch.

NRE amortization structure (who shares which design entity) is encoded as
integer id arrays + flat (instance -> system) index maps so the Eq. (6)-(8)
entity de-duplication runs on the device via segment sums:

* chip designs   -> ``chip_entity_id``  (N, C) into ``chip_entity_*``
* package designs-> ``pkg_entity_id``   (N,)   into ``pkg_entity_*``
* modules        -> flat ``mod_sys``/``mod_entity`` instance lists
* D2D interfaces -> flat ``d2d_sys``/``d2d_entity`` instance lists

``share_nre=True`` (default) treats the batch as one co-produced group,
matching ``nre_cost.amortized_costs(systems)``; ``share_nre=False`` prices
every system as its own group (entity keys namespaced per system), which
is what independent design-point sweeps want.  ``share_nre`` may also be a
sequence of integer group ids, one per system: entities are then shared
*within* a group but never across groups.

:func:`pad_batch` pads every axis of a built batch (systems, chip slots,
entity tables, instance lists) with cost-neutral rows, so that batches of
different sizes can share one shape.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..resilience.guards import validate_packed_arrays
from .system import System, spec
from .technology import node

_FLOAT = torch.float32
_INT = torch.int32
# Integer leaves: entity ids and instance -> system maps.
_INT_LEAVES = frozenset({"chip_entity_id", "pkg_entity_id", "mod_sys",
                         "mod_entity", "d2d_sys", "d2d_entity"})


@dataclasses.dataclass(frozen=True, eq=False)
class SystemBatch:
    """N heterogeneous systems as a struct of tensors.

    Shapes: N = number of systems, C = max_chips (padded), E* = number of
    unique design entities, M/D = total module / D2D instances.
    """

    # --- per chip slot, (N, C) float; padded slots are zeroed + masked ---
    chip_area: torch.Tensor          # die area incl. D2D share, mm^2
    chip_defect: torch.Tensor        # defect density, defects/cm^2
    chip_wafer_cost: torch.Tensor    # USD / wafer
    chip_cluster: torch.Tensor       # negative-binomial c, Eq. (1)
    chip_wafer_yield: torch.Tensor   # Y_wafer, Eq. (2)
    chip_sort_cost: torch.Tensor     # USD / wafer (probe/sort)
    chip_bump_cost: torch.Tensor     # USD / mm^2 (C4 bumping)
    chip_mask: torch.Tensor          # 1.0 for a real chip, 0.0 for padding
    # --- per system, (N,) float ---
    package_area: torch.Tensor       # resolved S_p (respects forced reuse area)
    package_area_factor: torch.Tensor
    substrate_cost: torch.Tensor     # USD / mm^2
    substrate_layer: torch.Tensor    # layer growth factor
    interposer_cost: torch.Tensor    # USD / mm^2 (0 for SoC/MCM)
    interposer_defect: torch.Tensor  # defects / cm^2
    interposer_area_factor: torch.Tensor
    interposer_cluster: torch.Tensor
    y2_chip_bond: torch.Tensor
    y3_substrate_bond: torch.Tensor
    assembly_yield: torch.Tensor
    bond_cost_per_chip: torch.Tensor
    quantity: torch.Tensor
    # --- NRE entity structure ---
    chip_entity_id: torch.Tensor     # (N, C) int, padded slots point at 0
    chip_entity_area: torch.Tensor   # (Ec,)
    chip_entity_k: torch.Tensor      # (Ec,) K_c per mm^2
    chip_entity_fixed: torch.Tensor  # (Ec,) C per chip design
    pkg_entity_id: torch.Tensor      # (N,) int
    pkg_entity_area: torch.Tensor    # (Ep,)
    pkg_entity_k: torch.Tensor       # (Ep,) K_p per mm^2
    pkg_entity_fixed: torch.Tensor   # (Ep,) C_p
    mod_sys: torch.Tensor            # (M,) int — owning system of the instance
    mod_entity: torch.Tensor         # (M,) int
    mod_entity_area: torch.Tensor    # (Em,)
    mod_entity_k: torch.Tensor       # (Em,) K_m per mm^2
    d2d_sys: torch.Tensor            # (D,) int
    d2d_entity: torch.Tensor         # (D,) int
    d2d_entity_nre: torch.Tensor     # (Ed,)
    # --- display-only metadata ---
    names: Tuple[str, ...] = ()

    _LEAVES = None  # filled in after class creation

    # -- convenience --------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.chip_area.device

    @property
    def n_systems(self) -> int:
        return self.chip_area.shape[0]

    @property
    def max_chips(self) -> int:
        return self.chip_area.shape[1]

    @property
    def n_chips(self) -> torch.Tensor:
        """(N,) number of real chips per system."""
        return self.chip_mask.sum(dim=-1)

    def replace(self, **kw) -> "SystemBatch":
        """Functional update — the hook for sweeps and gradients."""
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "SystemBatch":
        """The same batch with every leaf on ``device``."""
        return self.replace(**{f: getattr(self, f).to(device)
                               for f in self._LEAVES})

    def __len__(self) -> int:
        return self.n_systems

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_systems(cls, systems: Sequence[System],
                     max_chips: Optional[int] = None,
                     share_nre: Union[bool, Sequence[int]] = True,
                     device=None) -> "SystemBatch":
        """Pack :class:`System` objects into one batch on ``device``.

        ``share_nre=True`` amortizes design entities across the whole batch
        (the batch is one product group, as in ``amortized_costs``) and
        therefore requires unique system names; ``share_nre=False`` prices
        each system as a standalone group.  A sequence of integer group
        ids (one per system) shares entities within each group only —
        names must be unique within a group.
        """
        dev = resolve_device(device)
        systems = list(systems)
        if not systems:
            raise ValueError("empty system batch")
        if isinstance(share_nre, bool):
            groups = [0] * len(systems) if share_nre \
                else list(range(len(systems)))
        else:
            groups = [int(g) for g in share_nre]
            if len(groups) != len(systems):
                raise ValueError(
                    f"share_nre groups ({len(groups)}) != systems "
                    f"({len(systems)})")
        by_group: Dict[int, List[str]] = {}
        for s, g in zip(systems, groups):
            by_group.setdefault(g, []).append(s.name)
        for g, names in by_group.items():
            if len(set(names)) != len(names):
                raise ValueError(
                    "system names must be unique within a shared-NRE "
                    f"group (group {g})")
        n = len(systems)
        c = max(s.n_chips for s in systems)
        if max_chips is not None:
            if max_chips < c:
                raise ValueError(f"max_chips={max_chips} < widest system {c}")
            c = max_chips

        f = {k: np.zeros((n, c), np.float32) for k in
             ("area", "defect", "wafer_cost", "cluster", "wafer_yield",
              "sort_cost", "bump_cost", "mask")}
        f["wafer_yield"][:] = 1.0      # benign padding
        f["cluster"][:] = 1.0
        sysf = {k: np.zeros((n,), np.float32) for k in
                ("package_area", "package_area_factor", "substrate_cost",
                 "substrate_layer", "interposer_cost", "interposer_defect",
                 "interposer_area_factor", "interposer_cluster",
                 "y2_chip_bond", "y3_substrate_bond", "assembly_yield",
                 "bond_cost_per_chip", "quantity")}

        chip_ents: Dict = {}
        chip_ent_rows: List[Tuple[float, float, float]] = []
        pkg_ents: Dict = {}
        pkg_ent_rows: List[Tuple[float, float, float]] = []
        mod_ents: Dict = {}
        mod_ent_rows: List[Tuple[float, float]] = []
        d2d_ents: Dict = {}
        d2d_ent_rows: List[float] = []
        chip_ids = np.zeros((n, c), np.int32)
        mod_sys: List[int] = []
        mod_ent: List[int] = []
        d2d_sys: List[int] = []
        d2d_ent: List[int] = []
        pkg_ids = np.zeros((n,), np.int32)

        def _entity(table, rows, key, make_row):
            if key not in table:
                table[key] = len(rows)
                rows.append(make_row())
            return table[key]

        for i, s in enumerate(systems):
            t = s.tech
            ns = f"#{groups[i]}/"
            sysf["package_area"][i] = s.package_area
            sysf["package_area_factor"][i] = t.package_area_factor
            sysf["substrate_cost"][i] = t.substrate_cost_per_mm2
            sysf["substrate_layer"][i] = t.substrate_layer_factor
            sysf["interposer_cost"][i] = t.interposer_cost_per_mm2
            sysf["interposer_defect"][i] = t.interposer_defect_density
            sysf["interposer_area_factor"][i] = t.interposer_area_factor
            sysf["interposer_cluster"][i] = node(t.interposer_node).cluster_param
            sysf["y2_chip_bond"][i] = t.y2_chip_bond
            sysf["y3_substrate_bond"][i] = t.y3_substrate_bond
            sysf["assembly_yield"][i] = t.assembly_yield
            sysf["bond_cost_per_chip"][i] = t.bond_cost_per_chip
            sysf["quantity"][i] = s.quantity

            pkg_ids[i] = _entity(
                pkg_ents, pkg_ent_rows, ns + s.package_id,
                lambda: (s.package_area, t.nre_package_per_mm2,
                         t.nre_fixed_per_package))

            for j, chip in enumerate(s.chips):
                nd = chip.node
                f["area"][i, j] = chip.area_mm2
                f["defect"][i, j] = chip.defect_density
                f["wafer_cost"][i, j] = nd.wafer_cost
                f["cluster"][i, j] = nd.cluster_param
                f["wafer_yield"][i, j] = nd.wafer_yield
                f["sort_cost"][i, j] = nd.wafer_sort_cost
                f["bump_cost"][i, j] = nd.bump_cost_per_mm2
                f["mask"][i, j] = 1.0
                chip_ids[i, j] = _entity(
                    chip_ents, chip_ent_rows, ns + chip.name,
                    lambda: (chip.area_mm2, nd.nre_chip_per_mm2,
                             nd.nre_fixed_per_chip))
                for m in chip.modules:
                    if m.is_d2d:
                        d2d_sys.append(i)
                        d2d_ent.append(_entity(
                            d2d_ents, d2d_ent_rows, ns + m.process,
                            lambda: node(m.process).nre_d2d))
                    else:
                        mod_sys.append(i)
                        mod_ent.append(_entity(
                            mod_ents, mod_ent_rows, ns + m.name,
                            lambda: (m.area_mm2, m.node.nre_module_per_mm2)))

        # Numerical guardrail at the host/device boundary: a NaN defect
        # density or a yield of 1.3 here would flow silently through the
        # whole RE/NRE graph.  from_arrays skips it: its leaves may already
        # live on the device, where reading them would sync.
        problems = validate_packed_arrays(
            f, sysf, [s.name for s in systems])
        if problems:
            raise ValueError(
                "invalid system parameters: " + "; ".join(problems))

        chip_rows = np.asarray(chip_ent_rows, np.float32).reshape(-1, 3)
        pkg_rows = np.asarray(pkg_ent_rows, np.float32).reshape(-1, 3)
        mod_rows = np.asarray(mod_ent_rows, np.float32).reshape(-1, 2)
        host = dict(
            chip_area=f["area"], chip_defect=f["defect"],
            chip_wafer_cost=f["wafer_cost"], chip_cluster=f["cluster"],
            chip_wafer_yield=f["wafer_yield"],
            chip_sort_cost=f["sort_cost"], chip_bump_cost=f["bump_cost"],
            chip_mask=f["mask"],
            **{k: v for k, v in sysf.items()},
            chip_entity_id=chip_ids,
            chip_entity_area=chip_rows[:, 0], chip_entity_k=chip_rows[:, 1],
            chip_entity_fixed=chip_rows[:, 2],
            pkg_entity_id=pkg_ids,
            pkg_entity_area=pkg_rows[:, 0], pkg_entity_k=pkg_rows[:, 1],
            pkg_entity_fixed=pkg_rows[:, 2],
            mod_sys=mod_sys, mod_entity=mod_ent,
            mod_entity_area=mod_rows[:, 0], mod_entity_k=mod_rows[:, 1],
            d2d_sys=d2d_sys, d2d_entity=d2d_ent,
            d2d_entity_nre=d2d_ent_rows)
        return cls(**_to_device(host, dev),
                   names=tuple(s.name for s in systems))

    @classmethod
    def from_arrays(cls, *, names: Tuple[str, ...] = (), device=None,
                    **leaves) -> "SystemBatch":
        """Array-native constructor: build a batch straight from its leaf
        arrays (numpy arrays or tensors) with no packing.

        Leaves go to ``device`` as float32 / int32; a tensor that is
        already there in that type is taken as it is.  This is how a
        batch packed elsewhere crosses over (a JAX batch: ``device_get``
        its leaves).  All ``_LEAVES`` fields are required; axis sizes are
        cross-checked so a mis-assembled batch fails here rather than
        deep inside the engine's segment sums.
        """
        dev = resolve_device(device)
        missing = [f for f in cls._LEAVES if f not in leaves]
        extra = [k for k in leaves if k not in cls._LEAVES]
        if missing or extra:
            raise ValueError(
                f"from_arrays: missing leaves {missing}, unknown {extra}")
        a = _to_device(leaves, dev)
        if a["chip_area"].ndim != 2:
            raise ValueError("from_arrays: chip_area must be (N, C), got "
                             f"shape {tuple(a['chip_area'].shape)}")
        n, c = a["chip_area"].shape
        checks = {}
        for k in ("chip_defect", "chip_wafer_cost", "chip_cluster",
                  "chip_wafer_yield", "chip_sort_cost", "chip_bump_cost",
                  "chip_mask", "chip_entity_id"):
            checks[k] = (n, c)
        for k in ("package_area", "package_area_factor", "substrate_cost",
                  "substrate_layer", "interposer_cost", "interposer_defect",
                  "interposer_area_factor", "interposer_cluster",
                  "y2_chip_bond", "y3_substrate_bond", "assembly_yield",
                  "bond_cost_per_chip", "quantity", "pkg_entity_id"):
            checks[k] = (n,)
        for grp in (("chip_entity_area", "chip_entity_k",
                     "chip_entity_fixed"),
                    ("pkg_entity_area", "pkg_entity_k", "pkg_entity_fixed"),
                    ("mod_entity_area", "mod_entity_k"),
                    ("d2d_entity_nre",),
                    ("mod_sys", "mod_entity"), ("d2d_sys", "d2d_entity")):
            if a[grp[0]].ndim != 1:
                raise ValueError(
                    f"from_arrays: {grp[0]} must be 1-D, got shape "
                    f"{tuple(a[grp[0]].shape)}")
            for k in grp[1:]:
                checks[k] = tuple(a[grp[0]].shape)
        for k, want in checks.items():
            if tuple(a[k].shape) != tuple(want):
                raise ValueError(
                    f"from_arrays: {k} has shape {tuple(a[k].shape)}, "
                    f"expected {tuple(want)}")
        return cls(**a, names=tuple(names))

    @classmethod
    def from_specs(cls, specs: Sequence[Mapping],
                   max_chips: Optional[int] = None,
                   share_nre: Union[bool, Sequence[int]] = False,
                   device=None) -> "SystemBatch":
        """Build a batch straight from declarative spec dicts.

        Specs without a ``name`` get a unique positional one.  Defaults to
        ``share_nre=False`` — spec sweeps are usually independent design
        points, not a co-produced group.
        """
        systems = []
        for i, d in enumerate(specs):
            d = dict(d)
            d.setdefault("name", f"sys{i}")
            systems.append(spec(d))
        return cls.from_systems(systems, max_chips=max_chips,
                                share_nre=share_nre, device=device)


SystemBatch._LEAVES = tuple(
    fld.name for fld in dataclasses.fields(SystemBatch)
    if fld.name != "names")


def _to_device(leaves: Mapping, dev: torch.device) -> Dict[str, torch.Tensor]:
    """Each leaf as a float32 (int32 for ids) tensor on ``dev``: a host
    array is copied once, a tensor already there in its type is kept."""
    out = {}
    for k, v in leaves.items():
        dt = _INT if k in _INT_LEAVES else _FLOAT
        out[k] = v.to(device=dev, dtype=dt) if isinstance(v, torch.Tensor) \
            else torch.tensor(np.asarray(v), dtype=dt, device=dev)
    return out


# ---------------------------------------------------------------------------
# Constant-shape padding.
# ---------------------------------------------------------------------------

# Leaves whose cost-neutral padding value is 1.0, not 0.0 (yields and
# divisors that must stay benign for padded rows).
_PAD_ONE = frozenset({
    "chip_wafer_yield", "chip_cluster", "package_area_factor",
    "y2_chip_bond", "y3_substrate_bond", "assembly_yield",
    "interposer_cluster",
})


def pad_batch(b: SystemBatch, *, n_systems: Optional[int] = None,
              max_chips: Optional[int] = None,
              chip_entities: Optional[int] = None,
              pkg_entities: Optional[int] = None,
              mod_entities: Optional[int] = None,
              mod_instances: Optional[int] = None,
              d2d_entities: Optional[int] = None,
              d2d_instances: Optional[int] = None) -> SystemBatch:
    """Pad every axis of ``b`` to the requested sizes with cost-neutral rows.

    Padded systems have zero area, zero quantity and unit yields, so they
    price to zero RE and contribute nothing to any NRE amortization
    denominator (Eq. 6-8 shares of real systems are unchanged).  Padded
    entity rows carry zero NRE; padded module/D2D instances point at a
    padded (zero) entity row, or at a padded (zero-quantity) system when
    no entity row was added.  Padding only ever grows an axis; shrinking
    raises ``ValueError``.  The padding is done on the host; the result
    lands on ``b``'s device.
    """
    n0, c0 = b.chip_area.shape
    ec0 = b.chip_entity_area.shape[0]
    ep0 = b.pkg_entity_area.shape[0]
    em0 = b.mod_entity_area.shape[0]
    m0 = b.mod_sys.shape[0]
    ed0 = b.d2d_entity_nre.shape[0]
    d0 = b.d2d_sys.shape[0]
    tgt = {
        "n_systems": (n0, n0 if n_systems is None else int(n_systems)),
        "max_chips": (c0, c0 if max_chips is None else int(max_chips)),
        "chip_entities": (ec0, ec0 if chip_entities is None
                          else int(chip_entities)),
        "pkg_entities": (ep0, ep0 if pkg_entities is None
                         else int(pkg_entities)),
        "mod_entities": (em0, em0 if mod_entities is None
                         else int(mod_entities)),
        "mod_instances": (m0, m0 if mod_instances is None
                          else int(mod_instances)),
        "d2d_entities": (ed0, ed0 if d2d_entities is None
                         else int(d2d_entities)),
        "d2d_instances": (d0, d0 if d2d_instances is None
                          else int(d2d_instances)),
    }
    for k, (cur, want) in tgt.items():
        if want < cur:
            raise ValueError(f"pad_batch cannot shrink {k}: {cur} -> {want}")
    n1, c1 = tgt["n_systems"][1], tgt["max_chips"][1]
    ec1, ep1 = tgt["chip_entities"][1], tgt["pkg_entities"][1]
    em1, m1 = tgt["mod_entities"][1], tgt["mod_instances"][1]
    ed1, d1 = tgt["d2d_entities"][1], tgt["d2d_instances"][1]

    # A padded instance must park its NRE share somewhere harmless: a
    # padded zero-NRE entity row, else a padded zero-quantity system.
    if (m1 > m0 and em1 == em0 and n1 == n0) or \
       (d1 > d0 and ed1 == ed0 and n1 == n0):
        raise ValueError(
            "padding instances requires a padded entity row or a padded "
            "system to absorb them")

    def _np(x):
        return x.detach().cpu().numpy()

    def pad1(x, size, value=0.0):
        a = _np(x)
        return np.pad(a, (0, size - a.shape[0]), constant_values=value)

    def pad2(x, value=0.0):
        a = _np(x)
        return np.pad(a, ((0, n1 - n0), (0, c1 - c0)),
                      constant_values=value)

    out = {}
    for f in SystemBatch._LEAVES:
        a = getattr(b, f)
        val = 1.0 if f in _PAD_ONE else 0.0
        if f == "chip_entity_id":
            out[f] = pad2(a, 0)
        elif a.ndim == 2:
            out[f] = pad2(a, val)
        elif f == "pkg_entity_id":
            # padded systems point at a padded (zero-NRE) package entity
            # when one exists; entity 0 is safe regardless because padded
            # systems have quantity 0 (no denominator impact).
            out[f] = pad1(a, n1, ep0 if ep1 > ep0 else 0)
        elif f == "mod_sys":
            out[f] = pad1(a, m1, n0 if n1 > n0 else 0)
        elif f == "mod_entity":
            out[f] = pad1(a, m1, em0 if em1 > em0 else 0)
        elif f == "d2d_sys":
            out[f] = pad1(a, d1, n0 if n1 > n0 else 0)
        elif f == "d2d_entity":
            out[f] = pad1(a, d1, ed0 if ed1 > ed0 else 0)
        elif f in ("chip_entity_area", "chip_entity_k", "chip_entity_fixed"):
            out[f] = pad1(a, ec1)
        elif f in ("pkg_entity_area", "pkg_entity_k", "pkg_entity_fixed"):
            out[f] = pad1(a, ep1)
        elif f in ("mod_entity_area", "mod_entity_k"):
            out[f] = pad1(a, em1)
        elif f == "d2d_entity_nre":
            out[f] = pad1(a, ed1)
        else:                     # (N,) per-system float leaves
            out[f] = pad1(a, n1, val)
    names = b.names
    if names:
        names = tuple(names) + tuple(f"__pad{i}" for i in range(n1 - n0))
    return SystemBatch(**_to_device(out, b.device), names=names)
