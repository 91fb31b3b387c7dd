"""The port's training data (repro_torch.data) against the JAX package's
(repro.data) on the CPU: the same seeds give the same tokens, element for
element, GetPath answers included; the prefetcher places batches on the
device it is given; the corpus's graph lives on the card unless the caller
names another device."""
import numpy as np
import pytest
import torch

from repro.data import tokenizer as jtok
from repro.data.pathgen import PathTaskGenerator as JGen
from repro.data.pipeline import GraphPathData as JGraphData
from repro.data.pipeline import SyntheticLMData as JSynth
from repro_torch.data import tokenizer as ttok
from repro_torch.data.pathgen import PathTaskGenerator
from repro_torch.data.pipeline import (GraphPathData, Prefetcher,
                                       SyntheticLMData)


@pytest.mark.parametrize("step", range(4))
def test_graph_path_batches_equal_jax(step):
    got = GraphPathData(n_vertices=8, seed=0, device="cpu").batch(step, 2, 96)
    want = JGraphData(n_vertices=8, seed=0).batch(step, 2, 96)
    assert got.dtype == np.int32 and got.shape == (2, 96)
    np.testing.assert_array_equal(got, want)


def test_path_task_examples_equal_jax_with_their_answers():
    """Eight examples of one stream: the same edges, queries and GetPath
    answers; both a found path and a NOPATH answer occur."""
    t = PathTaskGenerator(n_vertices=8, capacity=32, seed=2, device="cpu")
    j = JGen(n_vertices=8, capacity=32, seed=2)
    kinds = set()
    for _ in range(8):
        ex = t.example()
        assert ex == j.example()
        kinds.add(ttok.PATH in ex)
        assert ex[0] == ttok.BOS and ex[-1] == ttok.EOS
    assert kinds == {True, False}
    assert t.state.vkey.device.type == "cpu"


@pytest.mark.parametrize("step", [0, 3, 17])
def test_synthetic_batches_equal_jax(step):
    got = SyntheticLMData(100, seed=5).batch(step, 4, 16)
    np.testing.assert_array_equal(got, JSynth(100, seed=5).batch(step, 4, 16))


def test_tokenizer_is_jax_s_token_for_token():
    edges = [(0, 12), (12, 7), (105, 3)]
    for path in ([0, 12, 7], []):
        ex = ttok.encode_example(edges, 0, 7, path)
        assert ex == jtok.encode_example(edges, 0, 7, path)
        assert ttok.decode(ex) == jtok.decode(ex)
    assert ttok.VOCAB_MIN == jtok.VOCAB_MIN


def test_prefetcher_places_batches_on_its_device():
    src = SyntheticLMData(50, seed=1)
    for device, kind in ((None, np.ndarray), ("cpu", torch.Tensor)):
        pf = Prefetcher(src, batch_size=2, seq_len=8, device=device,
                        start_step=3)
        try:
            for step in (3, 4):
                item = next(pf)
                assert item["step"] == step
                assert isinstance(item["tokens"], kind)
                np.testing.assert_array_equal(np.asarray(item["tokens"]),
                                              src.batch(step, 2, 8))
        finally:
            pf.stop()


def test_the_corpus_graph_defaults_to_the_card():
    if torch.cuda.is_available():
        assert PathTaskGenerator(n_vertices=4).state.vkey.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PathTaskGenerator(n_vertices=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphPathData(n_vertices=4).batch(0, 1, 8)
