"""Softmax scores of a classifier over a balanced labelled set.

Labels: every class ``per_class`` times, in a seeded order. Scores: unit
Gaussian logits (``logit_noise_std``) with ``logit_margin`` added to the
true class, softmaxed in float32.
"""
import torch


def make(config: dict, seed: int, device: torch.device):
    rows, classes = int(config["rows"]), int(config["classes"])
    if rows != classes * int(config["per_class"]):
        raise ValueError(f"rows {rows} is not classes {classes} times per_class {config['per_class']}")
    assumed = config["assumed"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    target = torch.randperm(rows, generator=gen, device=device) % classes
    logits = torch.randn(rows, classes, generator=gen, device=device, dtype=torch.float32)
    logits.mul_(float(assumed["logit_noise_std"]))
    logits[torch.arange(rows, device=device), target] += float(assumed["logit_margin"])
    preds = torch.softmax(logits, dim=1)
    return preds.contiguous(), target.to(getattr(torch, config["label_dtype"]))
