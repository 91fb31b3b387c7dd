"""Suppressed trace-purity violation (lint fixture)."""
import torch


class _Count(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        # deliberate: pins that inline allows reach device-path bodies
        n = x.sum().item()  # repro-torch-lint: allow(trace-purity)
        return x * n

    @staticmethod
    def backward(ctx, g):
        return g
