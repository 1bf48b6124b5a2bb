"""The buckling family on the program: ``make_buckling_model``'s
``BucklingTopologyAnalysis`` with the configuration's keywords."""


def build(model, device):
    from eigd_tpu_torch.models.buckling import make_buckling_model

    return make_buckling_model(device=device, **model)
