"""The port's copy of the processor builds the same batches as the JAX
package's (`plangen_tpu/tasks/processor.py`, which the port cannot import:
`plangen_tpu/tasks/__init__.py` imports the JAX pipeline)."""

import numpy as np
import pytest

from plangen_tpu.config import GenerationConfig
from plangen_tpu.tasks.processor import PlanGenProcessor as JaxProcessor
from plangen_tpu.text.tokenizer import ByteFallbackTokenizer
from plangen_tpu_torch.tasks.processor import PlanGenProcessor

CAPTIONS = ["a cat on a mat", "two dogs", "an empty room with a lamp"]
GROUNDINGS = [
    "<grounding><ref>cat</ref><box>[100, 100, 500, 500]</box></grounding>",
    "<grounding><ref>dog</ref><box>[0, 0, 480, 500]</box>"
    "<ref>dog</ref><box>[520, 500, 900, 900]</box></grounding>",
    "",
]
NEGATIVES = [
    dict(),
    dict(neg_captions=["blurry"] * 3),
    dict(neg_groundings=["", "<grounding><ref>dog</ref><box>[0, 0, 480, 500]"
                             "</box></grounding>", ""]),
    dict(neg_captions=["x", "y", "z"], neg_groundings=["", "", "<grounding></grounding>"]),
]


@pytest.fixture(scope="module")
def processors():
    tok = ByteFallbackTokenizer(vocab_size=512)
    gen = GenerationConfig()
    return (JaxProcessor(tok, image_tokens=4, gen=gen),
            PlanGenProcessor(tok, image_tokens=4, gen=gen))


def test_uni_batch_equal(processors):
    jax_proc, port = processors
    for a, b in zip(jax_proc.uni_batch(CAPTIONS, GROUNDINGS),
                    port.uni_batch(CAPTIONS, GROUNDINGS)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("parallel_size", [1, 2])
@pytest.mark.parametrize("neg", range(len(NEGATIVES)))
def test_cfg_batch_equal(processors, neg, parallel_size):
    jax_proc, port = processors
    ids, mask = jax_proc.uni_batch(CAPTIONS, GROUNDINGS)
    want = jax_proc.cfg_batch(ids, mask, parallel_size=parallel_size, **NEGATIVES[neg])
    got = port.cfg_batch(ids, mask, parallel_size=parallel_size, **NEGATIVES[neg])
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape[0] == 2 * len(CAPTIONS) * parallel_size
