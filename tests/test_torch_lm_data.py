"""The port's synthetic LM stream (``repro_torch.data.lm_data``) against
the JAX package's ``repro.data.lm_data``: the same (seed, step) gives the
same tokens and labels bit for bit (tolerance 0), unsharded and split
into shards."""

import numpy as np
import pytest
import torch

from repro.data import lm_data as ref

from repro_torch.data import lm_data


@pytest.mark.parametrize("shards", [0, 2])
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 250)])
def test_batch_at_equals_reference_bit_for_bit(seed, step, shards):
    want = ref.batch_at(seed, step, 4, 16, 500, shards=shards)
    got = lm_data.batch_at(seed, step, 4, 16, 500, shards=shards,
                           device="cpu")
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    shape = (2, 2, 16) if shards else (4, 16)
    assert tuple(got["tokens"].shape) == shape


def test_token_stream_equals_reference_and_resumes_at_any_step():
    want = list(ref.token_stream(5, 6, 6, 10, 49152, start_step=2,
                                 shards=3))
    got = list(lm_data.token_stream(5, 6, 6, 10, 49152, start_step=2,
                                    shards=3, device="cpu"))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    # the stream is a pure function of (seed, step)
    again = lm_data.batch_at(5, 4, 6, 10, 49152, shards=3, device="cpu")
    assert torch.equal(again["tokens"], got[2]["tokens"])


def test_zipf_probs_and_bigram_structure_match_reference():
    np.testing.assert_array_equal(lm_data._zipf_probs(1000),
                                  ref._zipf_probs(1000))
    b = lm_data.batch_at(1, 2, 3, 9, 100, device="cpu")
    toks = torch.cat([b["tokens"], b["labels"][:, -1:]], 1).numpy()
    np.testing.assert_array_equal(toks[:, 1::2], (toks[:, 0:-1:2] * 7 + 3)
                                  % 100)


def test_batch_at_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        lm_data.batch_at(0, 0, 2, 4, 10)
