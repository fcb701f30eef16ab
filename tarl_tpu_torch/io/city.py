"""Procedural real-city scenario, an OSM-like irregular street network
(ports ``tarl_tpu/io/city.py``: ``city_scenario``).

The simulator ingests MATSim city exports but ships none, so this
synthesizes one with the statistical properties of an OSM-derived export:
blue-noise intersections under a multi-district density field,
Delaunay-triangulated and thinned to street degree; arterial corridors between district hubs; a
river crossed by a few bridges; ~15% one-way local streets with strong
connectivity repaired; long links split by degree-2 shape nodes;
projected coordinates and opaque, insertion-ordered node ids (so the
sorted-id intersection order carries no locality, which the renumbering
search of :mod:`tarl_tpu_torch.network` absorbs); a gravity population of
morning commuters to ``num_dest_zones`` work hubs with a share of
coordinate plans and two persons the ingestion filters drop; and
export-shaped XML (gzip, DOCTYPE, comments, ``<attributes>`` blocks,
scientific-notation capacities, float ``permlanes``).

This copy uses numpy, scipy, gzip and json only, and draws in the
reference's order from one ``numpy.random.default_rng(seed)`` stream, so
it writes the reference's files byte for byte once decompressed (the gzip
header carries a time stamp) and the same ``city_stats.json``.
"""
from __future__ import annotations

import gzip
import os
from typing import Optional

import numpy as np


# ---------------------------------------------------------------------------
# density fields
# ---------------------------------------------------------------------------

def _density_field(rng, extent):
    """Random multi-Gaussian district density over the extent.

    Returns ``(centers [K,2], weights [K], sigmas [K], base)`` — evaluate
    with :func:`_eval_density`."""
    ex, ey = extent
    k = 12
    centers = np.stack(
        [rng.uniform(0.08 * ex, 0.92 * ex, k),
         rng.uniform(0.08 * ey, 0.92 * ey, k)], axis=1
    )
    # One dominant CBD + secondary centers.
    weights = rng.uniform(0.25, 0.6, k)
    weights[0] = 1.6
    centers[0] = (0.5 * ex + rng.uniform(-0.05, 0.05) * ex,
                  0.5 * ey + rng.uniform(-0.05, 0.05) * ey)
    sigmas = rng.uniform(0.06, 0.16, k) * min(ex, ey)
    sigmas[0] *= 1.4
    return centers, weights, sigmas, 0.04


def _eval_density(field, pts):
    centers, weights, sigmas, base = field
    d2 = ((pts[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    return base + (weights[None, :] * np.exp(-d2 / (2 * sigmas[None, :] ** 2))).sum(1)


def _blue_noise(rng, field, extent, n_target):
    """Density-adaptive Poisson-disk thinning: candidates drawn by density,
    accepted when no prior acceptance lies within the local radius
    (grid-hashed; radius ∝ 1/sqrt(density))."""
    ex, ey = extent
    n_cand = n_target * 10
    cand = np.stack([rng.uniform(0, ex, n_cand), rng.uniform(0, ey, n_cand)], 1)
    dens = _eval_density(field, cand)
    keep = rng.random(n_cand) < dens / dens.max()
    cand = cand[keep]
    dens = dens[keep]
    # Aim the DENSEST areas at ~rmin spacing; the 0.40 factor calibrates
    # the density-weighted acceptance to land near n_target.
    area = ex * ey
    rmin = 0.40 * np.sqrt(area / n_target)
    radius = rmin / np.sqrt(dens / dens.max())
    cell = rmin / np.sqrt(2.0)
    nx, ny = int(ex / cell) + 1, int(ey / cell) + 1
    grid = {}
    accepted: list = []
    acc_radius: list = []
    order = rng.permutation(cand.shape[0])
    for idx in order:
        p = cand[idx]
        r = radius[idx]
        cx, cy = int(p[0] / cell), int(p[1] / cell)
        reach = int(np.ceil(r / cell))
        ok = True
        for gx in range(max(0, cx - reach), min(nx, cx + reach + 1)):
            for gy in range(max(0, cy - reach), min(ny, cy + reach + 1)):
                for j in grid.get((gx, gy), ()):
                    q = accepted[j]
                    rr = min(r, acc_radius[j])
                    if (p[0] - q[0]) ** 2 + (p[1] - q[1]) ** 2 < rr * rr:
                        ok = False
                        break
                if not ok:
                    break
            if not ok:
                break
        if ok:
            grid.setdefault((cx, cy), []).append(len(accepted))
            accepted.append(p)
            acc_radius.append(r)
    return np.asarray(accepted)


def _river(extent, rng):
    """A west-east river polyline ``y(x)`` with gentle meanders."""
    ex, ey = extent
    y0 = rng.uniform(0.35, 0.6) * ey
    amp = rng.uniform(0.05, 0.10) * ey
    freq = rng.uniform(1.5, 2.5) * 2 * np.pi / ex
    phase = rng.uniform(0, 2 * np.pi)

    def y_of(x):
        return y0 + amp * np.sin(freq * x + phase) \
            + 0.35 * amp * np.sin(2.3 * freq * x + 1.7 * phase)

    return y_of


def _hms(t: int) -> str:
    return f"{t // 3600:02d}:{(t % 3600) // 60:02d}:{t % 60:02d}"


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

def city_scenario(
    root: str,
    name: Optional[str] = None,
    *,
    num_intersections: int = 9000,
    num_agents: int = 250000,
    num_dest_zones: int = 256,
    extent: tuple = (13000.0, 10500.0),
    false_easting: float = 683000.0,
    false_northing: float = 4930000.0,
    max_link_length: float = 450.0,
    one_way_frac: float = 0.15,
    num_bridges: int = 9,
    peak_start: int = 6 * 3600,
    peak_spread: int = 2 * 3600,
    coord_plan_frac: float = 0.02,
    seed: int = 7,
) -> str:
    """Generate the city under ``root/name`` (default ``City<k>k``) and
    return its directory: ``network.xml.gz``, ``population.xml.gz`` and
    ``city_stats.json``, the structural summary."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import (
        connected_components,
        dijkstra,
        minimum_spanning_tree,
    )
    from scipy.spatial import Delaunay

    name = name or f"City{num_intersections // 1000}k"
    rng = np.random.default_rng(seed)
    field = _density_field(rng, extent)

    pts = _blue_noise(rng, field, extent, num_intersections)
    n0 = pts.shape[0]

    # -- Delaunay mesh, thinned to street degree ---------------------------
    tri = Delaunay(pts)
    e = np.vstack([tri.simplices[:, [0, 1]], tri.simplices[:, [1, 2]],
                   tri.simplices[:, [0, 2]]])
    e.sort(axis=1)
    e = np.unique(e, axis=0)
    elen = np.linalg.norm(pts[e[:, 0]] - pts[e[:, 1]], axis=1)
    # Delaunay slivers on the hull produce km-long chords — drop outright.
    ok = elen < np.quantile(elen, 0.985)
    e, elen = e[ok], elen[ok]

    # -- river: sever crossings except the bridges -------------------------
    y_of = _river(extent, rng)
    side = np.sign(pts[:, 1] - y_of(pts[:, 0]))
    crossing = side[e[:, 0]] * side[e[:, 1]] < 0
    cross_idx = np.nonzero(crossing)[0]
    bridges = np.zeros(e.shape[0], bool)
    if cross_idx.size:
        # Pick crossings nearest to evenly spaced abscissae (short ones
        # preferred) — real bridge spacing.
        bx = 0.5 * (pts[e[cross_idx, 0], 0] + pts[e[cross_idx, 1], 0])
        targets = np.linspace(0.06 * extent[0], 0.94 * extent[0], num_bridges)
        for t in targets:
            score = np.abs(bx - t) + 3.0 * elen[cross_idx]
            bridges[cross_idx[np.argmin(score)]] = True
    keep = ~crossing | bridges
    e, elen, bridges = e[keep], elen[keep], bridges[keep]

    # -- largest connected component ---------------------------------------
    adj = coo_matrix(
        (np.ones(e.shape[0]), (e[:, 0], e[:, 1])), shape=(n0, n0)
    )
    ncc, lab = connected_components(adj, directed=False)
    if ncc > 1:
        main = np.argmax(np.bincount(lab))
        node_keep = lab == main
        remap = -np.ones(n0, np.int64)
        remap[node_keep] = np.arange(node_keep.sum())
        ek = node_keep[e[:, 0]] & node_keep[e[:, 1]]
        e, elen, bridges = remap[e[ek]], elen[ek], bridges[ek]
        pts = pts[node_keep]
    n = pts.shape[0]

    # -- thin to street-like degree, MST-protected -------------------------
    mst = minimum_spanning_tree(coo_matrix(
        (elen, (e[:, 0], e[:, 1])), shape=(n, n)
    )).tocoo()
    mst_set = set(zip(*np.sort(np.stack([mst.row, mst.col], 1), axis=1).T))
    in_mst = np.fromiter(
        ((a, b) in mst_set for a, b in e), bool, e.shape[0]
    )
    target_edges = int(1.32 * n)  # mean undirected degree ~2.64
    extra_budget = max(target_edges - int(in_mst.sum()), 0)
    # Prefer short edges; randomize so districts differ in texture.
    score = elen * rng.uniform(0.6, 1.6, e.shape[0])
    cand = np.nonzero(~in_mst & ~bridges)[0]
    chosen = cand[np.argsort(score[cand])[:extra_budget]]
    sel = in_mst | bridges
    sel[chosen] = True
    e, elen, bridges = e[sel], elen[sel], bridges[sel]

    # -- arterial corridors between district hubs --------------------------
    centers = field[0]
    hub = np.array([
        np.argmin(((pts - c) ** 2).sum(1)) for c in centers
    ])
    g = coo_matrix(
        (np.concatenate([elen, elen]),
         (np.concatenate([e[:, 0], e[:, 1]]),
          np.concatenate([e[:, 1], e[:, 0]]))), shape=(n, n)
    ).tocsr()
    _, pred = dijkstra(g, indices=hub, return_predecessors=True)
    eidx = {}
    for k, (a, b) in enumerate(e):
        eidx[(a, b)] = k
        eidx[(b, a)] = k
    arterial = np.zeros(e.shape[0], bool)
    for i in range(len(hub)):
        for j in range(len(hub)):
            if i == j:
                continue
            v = hub[j]
            while pred[i, v] >= 0:
                u = pred[i, v]
                arterial[eidx[(u, v)]] = True
                v = u
    arterial |= bridges

    # -- one-way locals, strong connectivity repaired ----------------------
    oneway = (~arterial) & (rng.random(e.shape[0]) < one_way_frac)
    flip = rng.random(e.shape[0]) < 0.5   # one-way direction per edge
    for _ in range(12):
        ow_u = np.where(flip[oneway], e[oneway, 1], e[oneway, 0])
        ow_v = np.where(flip[oneway], e[oneway, 0], e[oneway, 1])
        tw = ~oneway
        src = np.concatenate([ow_u, e[tw, 0], e[tw, 1]])
        dst = np.concatenate([ow_v, e[tw, 1], e[tw, 0]])
        dg = coo_matrix(
            (np.ones(src.shape[0]), (src, dst)), shape=(n, n)
        )
        nscc, slab = connected_components(dg, directed=True,
                                          connection="strong")
        if nscc == 1:
            break
        # Any one-way whose endpoints straddle SCCs reverts to two-way
        # (real cities repair exactly these with contraflow pairs).
        bad = slab[e[:, 0]] != slab[e[:, 1]]
        oneway &= ~bad
    else:
        oneway[:] = False

    # -- OSM-style segmentation of long links ------------------------------
    node_x = list(pts[:, 0])
    node_y = list(pts[:, 1])
    seg_from, seg_to, seg_len, seg_art, seg_ow, seg_orig = [], [], [], [], [], []
    curv = 1.0 + 0.12 * rng.random(e.shape[0])  # curvature factor
    for k, (a, b) in enumerate(e):
        L = elen[k] * curv[k]
        parts = max(int(np.ceil(L / max_link_length)), 1)
        chain = [int(a)]
        for s in range(1, parts):
            t = s / parts
            # shape points jittered off the chord — curved streets
            jx = rng.normal(0, 0.03) * elen[k]
            jy = rng.normal(0, 0.03) * elen[k]
            node_x.append(pts[a, 0] * (1 - t) + pts[b, 0] * t + jx)
            node_y.append(pts[a, 1] * (1 - t) + pts[b, 1] * t + jy)
            chain.append(len(node_x) - 1)
        chain.append(int(b))
        for s in range(parts):
            seg_from.append(chain[s])
            seg_to.append(chain[s + 1])
            seg_len.append(L / parts)
            seg_art.append(bool(arterial[k]))
            seg_ow.append(bool(oneway[k]))
            seg_orig.append(k)
    seg_from = np.asarray(seg_from)
    seg_to = np.asarray(seg_to)
    seg_len = np.asarray(seg_len)
    seg_art = np.asarray(seg_art)
    seg_ow = np.asarray(seg_ow)
    seg_orig = np.asarray(seg_orig)
    flip_e = flip  # per original edge

    # -- link attribute tables ---------------------------------------------
    n_nodes = len(node_x)
    # Node ids: insertion-ordered opaque strings; the sorted-string order
    # interleaves mesh and shape nodes — zero locality by construction.
    node_ids = [f"osm{7000000 + 13 * i}" for i in range(n_nodes)]

    lanes_art = rng.choice([2.0, 3.0], e.shape[0], p=[0.7, 0.3])
    speed_art = rng.choice([16.67, 22.22], e.shape[0], p=[0.8, 0.2])
    lanes_loc = rng.choice([1.0, 2.0], e.shape[0], p=[0.85, 0.15])
    speed_loc = rng.choice([8.33, 13.89], e.shape[0], p=[0.45, 0.55])

    links = []

    def _emit(u, v, k, s):
        art = seg_art[s]
        lanes = lanes_art[k] if art else lanes_loc[k]
        speed = speed_art[k] if art else speed_loc[k]
        capacity = (1800.0 if art else 900.0) * lanes
        links.append(dict(
            id=f"L{len(links)}",
            frm=node_ids[u], to=node_ids[v],
            length=round(float(seg_len[s]), 3),
            capacity=capacity, freespeed=speed, permlanes=lanes,
            oneway=seg_ow[s], origid=int(seg_orig[s]),
            arterial=bool(art),
        ))

    for s in range(seg_from.shape[0]):
        k = seg_orig[s]
        u, v = int(seg_from[s]), int(seg_to[s])
        if seg_ow[s]:
            if flip_e[k]:
                _emit(v, u, k, s)
            else:
                _emit(u, v, k, s)
        else:
            _emit(u, v, k, s)
            _emit(v, u, k, s)

    # -- population ---------------------------------------------------------
    node_xy = np.stack([np.asarray(node_x), np.asarray(node_y)], 1)
    mesh_nodes = np.arange(n)  # original intersections (not shape nodes)
    dens_home = _eval_density(field, node_xy[mesh_nodes])
    # Residential field: suppress the CBD core, boost the periphery.
    cbd = field[0][0]
    d_cbd = np.linalg.norm(node_xy[mesh_nodes] - cbd, axis=1)
    home_w = (0.3 + dens_home) * (0.35 + np.tanh(d_cbd / 2500.0))
    home_w /= home_w.sum()
    # Work hubs: num_dest_zones nodes drawn by employment density.
    work_w = dens_home ** 1.6
    work_w /= work_w.sum()
    zone_nodes = rng.choice(mesh_nodes, size=num_dest_zones, replace=False,
                            p=work_w)
    zone_pick_w = work_w[zone_nodes] / work_w[zone_nodes].sum()

    homes = rng.choice(mesh_nodes, size=num_agents, p=home_w)
    works = zone_nodes[rng.choice(num_dest_zones, size=num_agents,
                                  p=zone_pick_w)]
    same = homes == works
    while same.any():
        homes[same] = rng.choice(mesh_nodes, size=int(same.sum()), p=home_w)
        same = homes == works
    deps = peak_start + (
        rng.beta(2.2, 2.8, num_agents) * peak_spread
    ).astype(np.int64)
    coord_plan = rng.random(num_agents) < coord_plan_frac

    # -- serialize (quirky, real-export-shaped XML) ------------------------
    base = os.path.join(root, name)
    os.makedirs(base, exist_ok=True)

    parts = [
        '<?xml version="1.0" encoding="utf-8"?>',
        '<!DOCTYPE network SYSTEM "http://www.matsim.org/files/dtd/network_v2.dtd">',
        "<network>",
        "<!-- generated from OSM extract; projected CRS, meters -->",
        ' <attributes>',
        '  <attribute name="coordinateReferenceSystem" class="java.lang.String">EPSG:32633</attribute>',
        " </attributes>",
        " <nodes>",
    ]
    for i, nid in enumerate(node_ids):
        parts.append(
            f'  <node id="{nid}" x="{node_x[i] + false_easting:.2f}" '
            f'y="{node_y[i] + false_northing:.2f}"/>'
        )
    parts.append(
        ' <!-- links: capacity per capperiod; freespeed in m/s -->'
    )
    parts.append(
        ' </nodes>'
    )
    parts.append(
        ' <links capperiod="01:00:00" effectivecellsize="7.5" '
        'effectivelanewidth="3.75">'
    )
    for l in links:
        cap = f"{l['capacity']:.1f}" if l["arterial"] else (
            f"{l['capacity'] / 1000.0:g}e3" if l["capacity"] >= 1000
            else f"{l['capacity']:.1f}"
        )
        extra = ' modes="car"'
        if l["oneway"]:
            extra += ' oneway="1"'
        parts.append(
            f'  <link id="{l["id"]}" from="{l["frm"]}" to="{l["to"]}" '
            f'length="{l["length"]}" capacity="{cap}" '
            f'freespeed="{l["freespeed"]}" permlanes="{l["permlanes"]}"'
            f'{extra} origid="{l["origid"]}"/>'
        )
    parts.append(" </links>")
    parts.append("</network>")
    with gzip.open(os.path.join(base, "network.xml.gz"), "wt") as f:
        f.write("\n".join(parts))

    parts = [
        '<?xml version="1.0" encoding="utf-8"?>',
        '<!DOCTYPE population SYSTEM "http://www.matsim.org/files/dtd/population_v6.dtd">',
        "<population>",
        "<!-- morning commute; sampled from census OD -->",
    ]
    for i in range(num_agents):
        h, w = node_ids[homes[i]], node_ids[works[i]]
        parts.append(f' <person id="c{i}">')
        parts.append("  <attributes>")
        parts.append('   <attribute name="carAvail" class="java.lang.String">always</attribute>')
        parts.append(f'   <attribute name="age" class="java.lang.Integer">{int(18 + (i * 37) % 62)}</attribute>')
        parts.append(f'   <attribute name="sex" class="java.lang.String">{"f" if (i * 11) % 2 else "m"}</attribute>')
        parts.append('   <attribute name="employed" class="java.lang.Boolean">yes</attribute>')
        parts.append("  </attributes>")
        parts.append("  <plan selected=\"yes\">")
        if coord_plan[i]:
            hx = node_xy[homes[i], 0] + false_easting + 18.0
            hy = node_xy[homes[i], 1] + false_northing - 11.0
            wx = node_xy[works[i], 0] + false_easting - 7.0
            wy = node_xy[works[i], 1] + false_northing + 23.0
            parts.append(
                f'   <act type="home" x="{hx:.2f}" y="{hy:.2f}" '
                f'end_time="{_hms(int(deps[i]))}"/>'
            )
            parts.append('   <leg mode="car"/>')
            parts.append(f'   <act type="work" x="{wx:.2f}" y="{wy:.2f}"/>')
        else:
            parts.append(
                f'   <act type="home" link="{h}" '
                f'end_time="{_hms(int(deps[i]))}"/>'
            )
            parts.append('   <leg mode="car"/>')
            parts.append(f'   <act type="work" link="{w}"/>')
        parts.append("  </plan>")
        parts.append(" </person>")
    # Real exports carry persons the ingestion filters drop.
    parts.append(' <person id="nocar0">')
    parts.append("  <attributes>")
    parts.append('   <attribute name="carAvail">never</attribute>')
    parts.append("  </attributes>")
    parts.append('  <plan><act type="home" link="%s" end_time="07:00:00"/>'
                 '<leg mode="pt"/><act type="work" link="%s"/></plan>'
                 % (node_ids[0], node_ids[1]))
    parts.append(" </person>")
    parts.append(' <person id="stayhome0">')
    parts.append("  <attributes>")
    parts.append('   <attribute name="carAvail">always</attribute>')
    parts.append("  </attributes>")
    parts.append(f'  <plan><act type="home" link="{node_ids[2]}"/></plan>')
    parts.append(" </person>")
    parts.append("</population>")
    with gzip.open(os.path.join(base, "population.xml.gz"), "wt") as f:
        f.write("\n".join(parts))

    # -- structural summary -------------------------------------------------
    import json

    deg = np.bincount(np.concatenate([seg_from, seg_to]),
                      minlength=n_nodes)
    stats = dict(
        name=name,
        nodes=int(n_nodes),
        mesh_intersections=int(n),
        links=len(links),
        one_way_links=int(sum(1 for l in links if l["oneway"])),
        arterial_links=int(sum(1 for l in links if l["arterial"])),
        bridges=int(bridges.sum()),
        mean_degree=float(deg.mean()),
        degree_hist={int(k): int(v) for k, v in
                     zip(*np.unique(deg, return_counts=True))},
        mean_link_m=float(np.mean([l["length"] for l in links])),
        max_link_m=float(np.max([l["length"] for l in links])),
        agents=int(num_agents),
        dest_zones=int(num_dest_zones),
        coord_plans=int(coord_plan.sum()),
        seed=int(seed),
    )
    with open(os.path.join(base, "city_stats.json"), "w") as f:
        json.dump(stats, f, indent=1)
    return base
