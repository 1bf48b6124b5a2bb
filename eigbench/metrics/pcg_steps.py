"""Shift-invert factor: the steps of the multigrid factor's PCG loops
(``ops.sync.LOOP_STEPS`` of the sites ``pcg_f32_planes``, ``pcg_f32`` and
``pcg_f64``) per design iteration; nothing where no such loop ran."""

SITES = ("pcg_f32_planes", "pcg_f32", "pcg_f64")


def read(run):
    steps = sum(run.loop_steps.get(s, 0) for s in SITES)
    return steps / run.iterations if steps else None
