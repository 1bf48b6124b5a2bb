"""Carry state across from the JAX package, as numpy arrays.

This system has no weights: its parameters are the design vector, the
mesh, the filter and the built shift-invert factor. The functions here
turn numpy arrays (taken from ``eigd_tpu`` objects with ``np.asarray`` by
the caller, so this module never imports jax) into the port's objects on a
given device. The parity tests use them to run both packages on identical
state, e.g. a multigrid factor whose Chebyshev bounds came from JAX's
random power-iteration start.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fem.filter import NodeFilter
from .models.buckling import BucklingTopologyAnalysis
from .models.crm import CRM
from .models.natural_frequency import TopologyAnalysis
from .models.thermal import ThermalTopologyAnalysis
from .ops.factor import CholeskyFactor
from .ops.multigrid import GridMGFactor
from .ops.stencil import GridStencilOperator


def _t(a, device, dtype=None):
    return None if a is None else torch.as_tensor(np.array(a), dtype=dtype,
                                                  device=device)


def filter_from_numpy(conn, X, r0, ftype, state, dvmap=None,
                      num_design_vars=None, grid_shape=None, device="cuda",
                      **options):
    """A ``NodeFilter`` of type ``ftype`` holding JAX's filter state:
    the conv kernel (``_kernel``), the spatial ELL pair (``idx``, ``wts``)
    or the Helmholtz pair (the factored matrix A, ``_Bmat``). ``options``
    are the filter's projection fields (beta, eta, projection).

    The state is built once on the given device by the constructor (the
    spatial one from a ``KDTree``) and then replaced by JAX's, so both
    packages filter with the same numbers."""
    fltr = NodeFilter(conn, X, r0=r0, ftype=ftype, dvmap=dvmap,
                      num_design_vars=num_design_vars,
                      grid_shape=grid_shape, device=device, **options)
    if ftype == "conv":
        fltr._kernel = _t(state, device, torch.float64)
    elif ftype == "spatial":
        fltr.idx = _t(state[0], device, torch.int64)
        fltr.wts = _t(state[1], device, torch.float64)
    else:
        A, Bmat = (_t(a, device, torch.float64) for a in state)
        fltr._chol = CholeskyFactor.from_matrix(A)
        fltr._Bmat = Bmat
    return fltr


def analysis_from_numpy(x, X, conn, dvmap, num_design_vars, filter_state,
                        grid_shape, r0, device="cuda", projection=False,
                        beta=10.0, eta=0.5, ftype="conv", uniform_grid=True,
                        **config):
    """A ``TopologyAnalysis`` on the given state.

    x : design vector; X, conn : the mesh; dvmap, num_design_vars,
    filter_state, r0, ftype : the filter (see ``filter_from_numpy``);
    grid_shape, uniform_grid (that of JAX's ``make_model``) and ``config``
    (the TopologyAnalysis keyword fields: factor_kind, N, m, sigma,
    lanczos_*, factor_options, adjoint_options, ...).
    """
    fltr = filter_from_numpy(conn, X, r0, ftype, filter_state, dvmap=dvmap,
                             num_design_vars=num_design_vars,
                             grid_shape=grid_shape, device=device,
                             projection=projection, beta=beta, eta=eta)
    topo = TopologyAnalysis(fltr, conn, X, grid_shape=grid_shape,
                            uniform_grid=uniform_grid, device=device,
                            **config)
    topo.x = _t(x, device, torch.float64)
    return topo


def thermal_from_numpy(x, X, conn, element_sets, filter_state, grid_shape,
                       r0, device="cuda", dvmap=None, num_design_vars=None,
                       projection=False, beta=10.0, eta=0.5, **config):
    """A ``ThermalTopologyAnalysis`` on the given state.

    x : design vector; X, conn : the mesh; element_sets : the named element
    sets; filter_state : the spatial filter's ELL pair (idx, wts), with
    dvmap, num_design_vars, r0 and the projection fields; grid_shape and
    ``config`` (the analysis' keyword fields: factor_kind, N, Ntarget, m,
    sigma, lanczos_*, factor_options, ...).
    """
    fltr = filter_from_numpy(conn, X, r0, "spatial", filter_state,
                             dvmap=dvmap, num_design_vars=num_design_vars,
                             device=device, projection=projection, beta=beta,
                             eta=eta)
    topo = ThermalTopologyAnalysis(fltr, conn, X, element_sets=element_sets,
                                   grid_shape=grid_shape, device=device,
                                   **config)
    topo.x = _t(x, device, torch.float64)
    return topo


def buckling_from_numpy(x, X, conn, free_dofs, forces, filter_state, r0,
                        v0=None, device="cuda", dvmap=None,
                        num_design_vars=None, projection=False, beta=10.0,
                        eta=0.5, **config):
    """A ``BucklingTopologyAnalysis`` on the given state.

    x : design vector; X, conn : the mesh; free_dofs, forces : the
    boundary and the load; filter_state : the spatial filter's ELL pair
    (idx, wts), with r0, dvmap, num_design_vars and the projection fields;
    v0 : the Lanczos start vector (JAX's, as numpy: free-DOF length on the
    dense path, full length and zero on the fixed DOFs on the masked one),
    or None for the port's own; ``config`` : the analysis' keyword fields
    (factor_kind, grid_shape, N, m, sigma, adjoint_method, ...).
    """
    fltr = filter_from_numpy(conn, X, r0, "spatial", filter_state,
                             dvmap=dvmap, num_design_vars=num_design_vars,
                             device=device, projection=projection, beta=beta,
                             eta=eta)
    topo = BucklingTopologyAnalysis(fltr, conn, X, free_dofs, forces,
                                    device=device, **config)
    topo.x = _t(x, device, torch.float64)
    if v0 is not None:
        v = _t(v0, device, torch.float64)
        topo.problem = dataclasses.replace(topo.problem, v0=lambda th: v)
    return topo


def crm_from_numpy(mesh, x, v0=None, device="cuda", **config):
    """A ``CRM`` on the given state.

    mesh : dict of X, conn, comp, names, station (the node -> station
    map; JAX's ``station_of_node``) and thickness (None for t0); x : the
    thickness design vector; v0 : the Lanczos start vector (JAX's, as
    numpy: full padded length on the scalable path, free-DOF length on the
    dense one), or None for the port's own; ``config`` : the CRM keyword
    fields (N, m, E, nu, rho, factor_kind, lanczos_*, ...).
    """
    crm = CRM(_mesh=mesh, device=device, **config)
    crm.x = _t(x, device, torch.float64)
    if v0 is not None:
        v = _t(v0, device, torch.float64)
        crm.problem = dataclasses.replace(crm.problem, v0=lambda th: v)
    return crm


def stencil_operator_from_numpy(W, mats, dofs, n, grid_shape, ndof,
                                device="cuda"):
    """A ``GridStencilOperator`` from its stencil W (X, Y, 3, 3, ndof,
    ndof), element matrices and DOF map (either may be None)."""
    return GridStencilOperator(_t(mats, device),
                               _t(dofs, device, torch.int64), n,
                               _t(W, device), grid_shape, ndof)


def mg_factor_from_numpy(Ws, dinvs, lmaxs, coarse_inv, W64, shapes, ndof,
                         device="cuda", **options):
    """A ``GridMGFactor`` holding a built hierarchy: level stencils, Jacobi
    inverses, lambda_max values, the dense coarse inverse and the f64 fine
    stencil. ``options`` are the factor's keyword fields (rtol, maxiter,
    approx_rtol, vcycle, ...)."""
    return GridMGFactor([_t(W, device, torch.float32) for W in Ws],
                        [_t(d, device, torch.float32) for d in dinvs],
                        [float(v) for v in lmaxs],
                        _t(coarse_inv, device, torch.float32),
                        _t(W64, device, torch.float64), shapes, ndof,
                        **options)


def padded_index(part):
    """(n,) position of each global DOF of a line-partitioned grid
    (``parallel.grid.GridPartition``) in the padded layout of concatenated
    rank shards (line l on rank l // L at local line l % L)."""
    b = part.line_dofs
    rank, lo = np.divmod(np.arange(part.nlines), part.L)
    start = rank * part.n_local + lo * b
    return (start[:, None] + np.arange(b)[None, :]).reshape(-1)


def to_padded(x, part):
    """Global (n,) or (n, k) array or tensor -> the padded shard layout
    (n_padded, ...), zero on padded lines."""
    idx = padded_index(part)
    shape = (part.n_padded,) + tuple(x.shape[1:])
    if isinstance(x, torch.Tensor):
        out = x.new_zeros(shape)
        out[torch.as_tensor(idx, device=x.device)] = x
        return out
    out = np.zeros(shape, dtype=np.asarray(x).dtype)
    out[idx] = x
    return out


def from_padded(y, part):
    """Inverse of ``to_padded``: the global rows of a padded array."""
    idx = padded_index(part)
    if isinstance(y, torch.Tensor):
        return y[torch.as_tensor(idx, device=y.device)]
    return np.asarray(y)[idx]
