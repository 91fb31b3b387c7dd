"""Deliberate trace-purity violations on the device path (lint fixture)."""
import random
import time

import numpy as np
import torch


def helper(x):
    t = time.perf_counter()  # LINT-EXPECT: trace-purity
    n = x.sum().item()  # LINT-EXPECT: trace-purity
    return x + t + n


def deeper(x):
    if bool(x.any()):  # LINT-EXPECT: trace-purity
        torch.cuda.synchronize()  # LINT-EXPECT: trace-purity
    return x.cpu()  # LINT-EXPECT: trace-purity


class _Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = helper(x)
        host = np.asarray(x)  # LINT-EXPECT: trace-purity
        return x * float(host.sum())

    @staticmethod
    def backward(ctx, g):
        noise = np.random.rand()  # LINT-EXPECT: trace-purity
        rows = deeper(g).tolist()  # LINT-EXPECT: trace-purity
        return g * noise + random.random() + len(rows)  # LINT-EXPECT: trace-purity


def host_only(x):
    # NOT on the device path: clocks and host copies are fine here
    return time.time() + float(np.asarray(x.cpu()).sum())
