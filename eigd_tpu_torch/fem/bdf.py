"""Minimal NASTRAN bulk-data (BDF) reader for shell modal analysis.

The port's own copy of ``eigd_tpu/fem/bdf.py`` (plain numpy; this package
imports nothing of ``eigd_tpu``). The reference builds the CRM wingbox from
a NASTRAN BDF through pyTACS; this is the dependency-free subset that
``CRM.from_bdf`` reads:

  GRID    node ids + coordinates (small-field, large-field, free-field)
  CQUAD4  4-node shell elements with property id
  PSHELL  shell property: material id + thickness (one design variable
          per property, mirroring the per-component TACS DVs)
  MAT1    isotropic material (E, nu, rho)
  SPC/SPC1 single-point constraints (clamped nodes)

plus continuation lines and NASTRAN's implicit-exponent number format
("1.2-3" == 1.2e-3). Unknown cards are skipped and named in
``BdfModel.skipped``.

The station (block) map the block-tridiagonal factor needs is not read
from the file (an arbitrary BDF has no span ordering): ``bfs_levels``
derives it as the breadth-first level structure of the node adjacency,
rooted at the constrained nodes. BFS levels couple only to adjacent
levels, so the level map is block tridiagonal for any mesh, and level 0
(the SPC nodes) is the layout's clamped station 0.
"""

from __future__ import annotations

import numpy as np

__all__ = ["parse_bdf", "bfs_levels", "BdfModel"]


def _nastran_float(tok):
    """NASTRAN numeric field: '1.2-3' means 1.2e-3, '1.2+3' 1.2e3."""
    tok = tok.strip()
    if not tok:
        return 0.0
    try:
        return float(tok)
    except ValueError:
        # insert the implied 'e' before a +/- that is not the leading sign
        for i in range(len(tok) - 1, 0, -1):
            if tok[i] in "+-" and tok[i - 1] not in "eEdD":
                return float(tok[:i] + "e" + tok[i:])
        raise


def _split_fields(line):
    """One logical card line -> list of string fields (field 0 = card name).

    Free field: comma separated. Small field: 8-char columns. Large field
    (16-char columns, 4 data fields per line): the name field either ends
    with '*' ("GRID*") or the line is a large-field continuation whose
    marker STARTS with '*' ("*ABC1") — both must select 16-char columns,
    or 16-char numerics are silently split/truncated.
    """
    if "," in line:
        return [f.strip() for f in line.split(",")]
    name = line[:8]
    if name.rstrip().endswith("*") or line.startswith("*"):
        fields = [name.rstrip().rstrip("*")]
        body = line[8:72]
        for i in range(0, len(body), 16):
            fields.append(body[i:i + 16].strip())
        return fields
    fields = [name.strip()]
    body = line[8:72]
    for i in range(0, len(body), 8):
        fields.append(body[i:i + 8].strip())
    return fields


def _logical_cards(lines):
    """Merge continuation lines into logical cards (list of field lists)."""
    cards = []
    for raw in lines:
        line = raw.rstrip("\n")
        if not line.strip() or line.lstrip().startswith("$"):
            continue
        fields = _split_fields(line)
        is_cont = (line[:1] in ("+", "*", " ") and cards) or (
            fields[0] == "" and cards)
        if is_cont and fields[0] in ("", "+", "*") or (
                fields and fields[0].startswith(("+", "*")) and cards):
            # continuation: append data fields (drop the marker field)
            if cards:
                cards[-1].extend(fields[1:])
                continue
        cards.append(fields)
    return cards


class BdfModel:
    """Parsed subset: arrays ready for the shell assembly pipeline."""

    def __init__(self, X, node_ids, conn, comp, names, thickness,
                 E, nu, rho, spc_nodes, skipped, warnings=()):
        self.X = X                  # (nnodes, 3) float
        self.node_ids = node_ids    # (nnodes,) original GRID ids
        self.conn = conn            # (nelems, 4) int, 0-based
        self.comp = comp            # (nelems,) property index per element
        self.component_names = names  # per-property label ("PSHELL <pid>")
        self.thickness = thickness  # (ncomp,) initial thickness per property
        self.E, self.nu, self.rho = E, nu, rho
        self.spc_nodes = spc_nodes  # (k,) 0-based constrained node indices
        self.skipped = skipped      # set of skipped card names
        self.warnings = list(warnings)  # lossy-promotion notices


def parse_bdf(path_or_lines):
    """Parse the supported BDF subset. Accepts a path or iterable of lines."""
    if isinstance(path_or_lines, (str, bytes)):
        with open(path_or_lines) as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)

    grids = {}       # id -> (x, y, z)
    quads = []       # (pid, n1..n4)
    pshell = {}      # pid -> (mid, t)
    mats = {}        # mid -> (E, nu, rho)
    spc = set()
    skipped = set()
    warnings = []
    spc_comps = set()  # component strings seen on SPC/SPC1/GRID cards

    in_bulk = any("BEGIN BULK" in ln.upper() for ln in lines)
    started = not in_bulk
    for card in _logical_cards(lines):
        name = card[0].upper()
        if not started:
            if name.startswith("BEGIN"):
                started = True
            continue
        if name in ("ENDDATA", "END DATA"):
            break
        f = card + [""] * 12
        if name == "GRID":
            nid = int(f[1])
            grids[nid] = (_nastran_float(f[3]), _nastran_float(f[4]),
                          _nastran_float(f[5]))
            # permanent SPC in field 8
            if f[7].strip():
                spc.add(nid)
                spc_comps.add(f[7].strip())
        elif name == "CQUAD4":
            quads.append((int(f[2]), int(f[3]), int(f[4]), int(f[5]),
                          int(f[6])))
        elif name == "PSHELL":
            pshell[int(f[1])] = (int(f[2]), _nastran_float(f[3]))
        elif name == "MAT1":
            E = _nastran_float(f[2])
            G = _nastran_float(f[3]) if f[3].strip() else 0.0
            nu = _nastran_float(f[4]) if f[4].strip() else (
                E / (2.0 * G) - 1.0 if G else 0.3)
            rho = _nastran_float(f[5]) if f[5].strip() else 0.0
            mats[int(f[1])] = (E, nu, rho)
        elif name == "SPC1":
            # SPC1 sid comps g1 g2 ... (also THRU ranges)
            if f[2].strip():
                spc_comps.add(f[2].strip())
            toks = [t for t in f[3:] if t.strip()]
            i = 0
            while i < len(toks):
                if toks[i].upper() == "THRU":
                    lo = int(toks[i - 1])
                    hi = int(toks[i + 1])
                    spc.update(range(lo, hi + 1))
                    i += 2
                else:
                    spc.add(int(toks[i]))
                    i += 1
        elif name == "SPC":
            # SPC sid g1 c1 d1 g2 c2 d2
            for j in (2, 5):
                if f[j].strip():
                    spc.add(int(f[j]))
                    if f[j + 1].strip():
                        spc_comps.add(f[j + 1].strip())
        else:
            skipped.add(name)

    if not grids:
        raise ValueError("BDF contains no GRID cards (or no BEGIN BULK)")
    if not quads:
        raise ValueError("BDF contains no CQUAD4 cards "
                         "(only the CQUAD4 shell subset is supported)")

    # keep only GRID nodes some CQUAD4 references: unreferenced grids (nodes
    # for unsupported element types, construction points) would contribute
    # 6 zero-stiffness/zero-mass DOFs each, making the shift factor singular
    referenced = {n for q in quads for n in q[1:]}
    missing = referenced - set(grids)
    if missing:
        raise ValueError(
            f"CQUAD4 references {len(missing)} undefined GRID ids "
            f"(e.g. {sorted(missing)[:5]})")
    dropped = len(grids) - len(referenced)
    if dropped:
        warnings.append(
            f"dropped {dropped} GRID node(s) not referenced by any CQUAD4")
    node_ids = np.array(sorted(referenced), dtype=np.int64)
    id2idx = {nid: i for i, nid in enumerate(node_ids)}
    X = np.array([grids[nid] for nid in node_ids])

    pids = sorted({q[0] for q in quads})
    pid2comp = {pid: i for i, pid in enumerate(pids)}
    conn = np.array([[id2idx[n] for n in q[1:]] for q in quads],
                    dtype=np.int32)
    comp = np.array([pid2comp[q[0]] for q in quads], dtype=np.int32)
    names = [f"PSHELL {pid}" for pid in pids]

    thickness = np.array([pshell.get(pid, (0, 0.01))[1] for pid in pids])
    # one isotropic material assumed (the subset's scope); take the first
    # referenced MAT1, else fall back to aluminum-ish defaults
    E, nu, rho = 70e9, 0.3, 2700.0
    for pid in pids:
        mid = pshell.get(pid, (None, None))[0]
        if mid in mats:
            E, nu, rho = mats[mid]
            break
    spc_idx = np.array(sorted(id2idx[n] for n in spc if n in id2idx),
                       dtype=np.int64)
    # the station layout clamps SPC nodes in ALL DOFs (level-0 clamp). A
    # deck constraining a strict component subset (e.g. "3") is promoted to
    # a full clamp — record it so callers can detect the stiffening
    # (reference honors per-DOF constraints, crm.py:146-183)
    partial = sorted(c for c in spc_comps
                     if not set("123456") <= set(c))
    if partial:
        warnings.append(
            "SPC component subset(s) "
            f"{partial} promoted to full 6-DOF clamps; frequencies will be "
            "stiffer than a per-DOF-constrained model")
    return BdfModel(X, node_ids, conn, comp, names, thickness, E, nu, rho,
                    spc_idx, skipped, warnings)


def bfs_levels(conn, nnodes, roots):
    """Breadth-first level structure of the node-adjacency graph.

    Edges exist between nodes sharing an element, so by construction a
    level-l node couples only to levels {l-1, l, l+1}: the level map is a
    valid block-tridiagonal station assignment for ANY mesh. Vectorized
    frontier sweeps (numpy) — no per-node Python.

    Returns (levels, nlevels); unreachable nodes (disconnected components)
    are appended as their own trailing levels per component.
    """
    conn = np.asarray(conn)
    k = conn.shape[1]
    src = np.repeat(conn, k, axis=1).reshape(-1)
    dst = np.tile(conn, (1, k)).reshape(-1)
    levels = np.full(nnodes, -1, dtype=np.int64)
    roots = np.asarray(sorted(set(int(r) for r in roots)), dtype=np.int64)
    if roots.size == 0:
        roots = np.array([0], dtype=np.int64)
    levels[roots] = 0
    cur = 0
    while True:
        frontier_mask = levels[src] == cur
        nxt = dst[frontier_mask]
        nxt = nxt[levels[nxt] < 0]
        if nxt.size == 0:
            # disconnected remainder: seed the next unreached node
            rest = np.nonzero(levels < 0)[0]
            if rest.size == 0:
                break
            levels[rest[0]] = cur + 1
            cur += 1
            continue
        levels[np.unique(nxt)] = cur + 1
        cur += 1
    return levels, int(levels.max()) + 1
