"""Natural-frequency example: the KS minimum-frequency gradient against a
central difference (``MinFreqOpt.test_ks_func``), the counterpart of
``examples/natural_frequency.py``.

    python -m eigd_tpu_torch.examples.natural_frequency \
        [sibk|laa|pcpg|pgmres] [nx ny] [mg|bcr_f32|bcr|blocktridiag|dense] \
        [plot] [--device cuda|cpu]
"""

import numpy as np

from . import split_device


def main(argv=None):
    """Returns ``test_ks_func``'s dict (ans, fd, fd_err and the profile)."""
    from ..models.natural_frequency import MinFreqOpt, make_model

    device, argv = split_device(argv)
    np.random.seed(0)
    method = "sibk"
    for cand in ("sibk", "laa", "pcpg", "pgmres"):
        if cand in argv:
            method = cand
    nx, ny = 32, 16
    sizes = [a for a in argv if a.isdigit()]
    if len(sizes) >= 2:
        nx, ny = int(sizes[0]), int(sizes[1])
    factor_kind = "dense"
    for cand in ("mg", "bcr_f32", "bcr", "blocktridiag", "blocktridiag_f32"):
        if cand in argv:
            factor_kind = cand
            break

    print(f"method = {method}, grid = {nx}x{ny}, factor = {factor_kind}, "
          f"device = {device}")
    topo = make_model(nx=nx, ny=ny, Lx=2.0, Ly=1.0, N=6,
                      adjoint_method=method, factor_kind=factor_kind,
                      lanczos_tol=(1e-12 if factor_kind != "dense" else None),
                      device=device)
    data = MinFreqOpt(topo).test_ks_func()

    if "plot" in argv:
        from ..utils.plot import plot_field, plot_mode

        plot_field(topo.X, topo.conn, topo.rho,
                   path="natural_frequency_design.png")
        plot_mode(topo.X, topo.conn, topo.rho, topo.Q[:, 0],
                  path="natural_frequency_mode0.png")
    return data


if __name__ == "__main__":
    main()
