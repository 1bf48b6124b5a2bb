"""Plots: density contours, mode shapes, residual curves and shell mode
shapes (counterpart of ``eigd_tpu/utils/plot.py``), drawn from numpy
copies of the tensors. Matplotlib is optional: without it every function
is a no-op. Plots are not on the compute path.
"""

from __future__ import annotations

import numpy as np


def _np(a):
    """A numpy copy of a tensor (on any device) or an array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _pyplot(agg=False):
    """matplotlib.pyplot (switched to the Agg backend with ``agg``), or
    None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    if agg:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _tri(conn):
    conn = _np(conn)
    nelems = conn.shape[0]
    tris = np.zeros((2 * nelems, 3), dtype=int)
    tris[:nelems] = conn[:, [0, 1, 2]]
    tris[nelems:] = conn[:, [0, 2, 3]]
    return tris


def _save(plt, fig, path, created):
    if path is not None and created:
        fig.savefig(path, bbox_inches="tight", dpi=150)
        plt.close(fig)


def plot_field(X, conn, field, u=None, scale=1.0, ax=None, path=None,
               **kwargs):
    """Nodal-field contour over the quad mesh (split into triangles),
    optionally on the mesh displaced by ``scale * u`` (2 DOFs a node)."""
    plt = _pyplot()
    if plt is None:
        return None
    import matplotlib.tri as mtri

    X = _np(X)
    x, y = X[:, 0].copy(), X[:, 1].copy()
    if u is not None:
        u = _np(u)
        x = x + scale * u[0::2]
        y = y + scale * u[1::2]
    tri_obj = mtri.Triangulation(x, y, _tri(conn))
    created = ax is None
    if created:
        fig, ax = plt.subplots()
    ax.set_aspect("equal")
    ax.tricontourf(tri_obj, _np(field).astype(float), **kwargs)
    ax.axis("off")
    _save(plt, ax.figure, path, created)
    return ax


def plot_mode(X, conn, rho, mode_shape, k_scale=0.5, ax=None, path=None):
    """Density on the mesh deformed by a mode shape scaled to
    ``k_scale``."""
    q = _np(mode_shape)
    value = abs(q.max()) + abs(q.min())
    scale = k_scale / value if value > 0 else 1.0
    return plot_field(X, conn, rho, u=q, scale=scale, ax=ax, path=path,
                      levels=np.linspace(0.0, 1.0, 26), cmap="viridis",
                      extend="max")


def plot_residuals(res_list, ax=None, path=None):
    """A residual history on a log scale."""
    plt = _pyplot()
    if plt is None:
        return None
    created = ax is None
    if created:
        fig, ax = plt.subplots()
    ax.semilogy(_np(res_list), marker="o", markersize=4)
    ax.set_xlabel("Iteration")
    ax.set_ylabel("Residual")
    _save(plt, ax.figure, path, created)
    return ax


def plot_shell_mode(X, conn, U, title, path, max_edges=2000):
    """A 3D wireframe of a shell mesh (nodes X (nnodes, 3), quads conn)
    displaced by U (nnodes, 3), at most ``max_edges`` quads drawn, written
    to ``path`` by the Agg backend. Returns path, or None without
    matplotlib."""
    plt = _pyplot(agg=True)
    if plt is None:
        return None
    Xd = _np(X) + _np(U)
    fig = plt.figure(figsize=(8, 5))
    ax = fig.add_subplot(111, projection="3d")
    quads = Xd[_np(conn)]  # (nelems, 4, 3)
    seg = np.concatenate([quads, quads[:, :1]], axis=1)
    for s in seg[::max(1, len(seg) // max_edges)]:
        ax.plot(s[:, 0], s[:, 1], s[:, 2], "b-", lw=0.3)
    ax.set_title(title)
    ax.set_box_aspect(tuple(np.ptp(Xd[:, i]) for i in range(3)))
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
