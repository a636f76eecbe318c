"""Click probabilities of a calibrated CTR model, and clicks drawn from them.

The score is ``sigmoid(logit_intercept + logit_scale * z)`` with ``z``
standard normal, rounded to float32; the click is 1 with that probability.
"""
import torch


def make(config: dict, seed: int, device: torch.device):
    rows = int(config["rows"])
    assumed = config["assumed"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    z = torch.randn(rows, generator=gen, device=device, dtype=torch.float32)
    preds = torch.sigmoid(z.mul_(float(assumed["logit_scale"])).add_(float(assumed["logit_intercept"])))
    u = torch.rand(rows, generator=gen, device=device, dtype=torch.float32)
    target = (u < preds).to(getattr(torch, config["label_dtype"]))
    return preds, target
