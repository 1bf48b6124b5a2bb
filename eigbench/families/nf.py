"""The natural-frequency family on the program: ``make_model``'s
``TopologyAnalysis`` with the configuration's keywords."""


def build(model, device):
    from eigd_tpu_torch.models.natural_frequency import make_model

    return make_model(device=device, **model)
