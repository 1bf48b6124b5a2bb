"""The CRM wingbox family on the program: ``CRM`` with the
configuration's keywords (the parametric wingbox mesh)."""


def build(model, device):
    from eigd_tpu_torch.models.crm import CRM

    return CRM(device=device, **model)
