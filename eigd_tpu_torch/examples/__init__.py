"""Command-line examples, the counterparts of the repository's
``examples/*.py``: ``python -m eigd_tpu_torch.examples.<name>`` with the
same words as the JAX script's and ``--device`` (default ``cuda``).
Each ``main(argv)`` returns the data it checks."""

import sys


def split_device(argv):
    """(device, the other words) of an example's arguments (``sys.argv``
    when ``argv`` is None): ``--device X``, by default "cuda"."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    return device, argv
