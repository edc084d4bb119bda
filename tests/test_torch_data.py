"""The port's copies of the jax-free data modules (`schema`, `toy`,
`collate`, `loader`) give the same samples, sample order and batches as the
JAX package's, and its registry knows `toy` only."""

import numpy as np
import pytest

from plangen_tpu.config import FlowConfig, GenerationConfig, PlanGenConfig, apply_overrides
from plangen_tpu.data import collate as jcollate
from plangen_tpu.data import loader as jloader
from plangen_tpu.data.registry import get_dataset as jget_dataset
from plangen_tpu.data.toy import ToyDataset as JaxToy
from plangen_tpu.tasks.processor import PlanGenProcessor as JaxProcessor
from plangen_tpu.text.tokenizer import ByteFallbackTokenizer
from plangen_tpu_torch.data import collate, loader
from plangen_tpu_torch.data.registry import ConcatDataset, get_dataset
from plangen_tpu_torch.data.toy import ToyDataset
from plangen_tpu_torch.tasks.processor import PlanGenProcessor

TASKS = {0: "uni", 1: "mmu", 2: "plan", 3: "t2i"}


@pytest.fixture(scope="module")
def processors():
    tok = ByteFallbackTokenizer(vocab_size=102400)
    gen = GenerationConfig()
    return (JaxProcessor(tok, image_tokens=16, max_seq_len=700, gen=gen),
            PlanGenProcessor(tok, image_tokens=16, max_seq_len=700, gen=gen))


@pytest.mark.parametrize("textual", [True, False])
def test_toy_samples_equal(textual):
    a, b = JaxToy(size=4, image_hw=64, textual=textual), ToyDataset(size=4, image_hw=64,
                                                                    textual=textual)
    assert len(a) == len(b)
    for i in range(len(a)):
        sa, sb = a[i], b[i]
        for field in vars(sa):
            va, vb = getattr(sa, field), getattr(sb, field)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb, err_msg=field)
            else:
                assert va == vb, field


@pytest.mark.parametrize("B", [1, 3])
def test_collated_flow_batches_equal(processors, B):
    jax_proc, port = processors
    ds = ToyDataset(size=8, image_hw=64)
    samples = {f: [ds[i] for i in range(B)] for f in TASKS}
    want = jcollate.collate_flows(samples, TASKS, jax_proc)
    got = collate.collate_flows(samples, TASKS, port)
    assert sorted(got) == sorted(want)
    for f in want:
        assert sorted(got[f]) == sorted(want[f]), TASKS[f]
        for k in want[f]:
            assert got[f][k].dtype == want[f][k].dtype, (TASKS[f], k)
            np.testing.assert_array_equal(got[f][k], want[f][k], err_msg=f"{TASKS[f]} {k}")


@pytest.mark.parametrize("workers,depth", [(0, 0), (2, 2)])
def test_loaders_yield_the_same_order(workers, depth):
    """Shuffled per-flow epochs, min-size combination, prefetch: the same
    sample ids in the same order over two epochs."""
    ds = ToyDataset(size=7, image_hw=16)

    def ids(mod):
        flows = {0: mod.BatchLoader(ds, 2, seed=3, workers=workers),
                 1: mod.BatchLoader(ds, 3, seed=4, workers=workers)}
        it = mod.CombinedLoader(flows)
        if depth:
            it = mod.PrefetchLoader(it, depth=depth)
        stream = mod.infinite(it)
        return [{f: [s.image_id for s in b] for f, b in next(stream).items()}
                for _ in range(5)]

    assert ids(loader) == ids(jloader)


def test_registry_knows_toy_only():
    cfg = apply_overrides(PlanGenConfig(janus_hw=32), {
        "train.train_data": (FlowConfig("uni", "toy", 2),)})
    ds = get_dataset(cfg, "toy")
    assert isinstance(ds, ToyDataset) and len(ds) == len(jget_dataset(cfg, "toy"))
    assert ds[0].image.shape == (32, 32, 3)
    both = get_dataset(cfg, ["toy", "toy"])
    assert isinstance(both, ConcatDataset) and len(both) == 2 * len(ds)
    assert both[len(ds) + 1].image_id == "1"
    with pytest.raises(IndexError):
        both[2 * len(ds)]
    # the real datasets are ported (tests/test_torch_datasets.py): an unknown
    # name raises KeyError, a known one without its files FileNotFoundError
    for name in ("layoutsam", ["toy", "nowhere"]):
        with pytest.raises(KeyError):
            get_dataset(cfg, name)
    with pytest.raises(FileNotFoundError):
        get_dataset(cfg, "hico_full")
