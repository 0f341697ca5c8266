"""Port vs JAX package: DDIM scheduler, chunk schedule, tokenizer, timestep
embedding.  The chunk schedule and the tokenizer are numpy / stdlib code
that the port carries itself (it imports nothing from vidtome_tpu), so they
must give identical output; the scheduler's float updates agree to fp32
rounding (atol 1e-6 on unit-scale inputs)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vidtome_torch.core import chunk as t_chunk
from vidtome_torch.core import scheduler as t_sch
from vidtome_torch.models import tokenizer as t_tok
from vidtome_torch.models.layers import timestep_embedding as t_temb
from vidtome_tpu.core import chunk as j_chunk
from vidtome_tpu.core import scheduler as j_sch
from vidtome_tpu.models import tokenizer as j_tok
from vidtome_tpu.models.layers import timestep_embedding as j_temb

torch.set_num_threads(2)


@pytest.mark.parametrize("steps", [5, 50])
def test_scheduler_tables_and_steps(steps):
    js, ts = j_sch.DDIMScheduler.create(steps), t_sch.DDIMScheduler.create(steps)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    np.testing.assert_array_equal(ts.alphas_cumprod, js.alphas_cumprod)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    eps = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    for i in range(steps):
        a = ts.sample_alpha_pair(i)
        np.testing.assert_allclose(a, np.asarray(js.sample_alpha_pair(i)),
                                   rtol=0, atol=0)
        b = ts.inversion_alpha_pair(i)
        np.testing.assert_allclose(b, np.asarray(js.inversion_alpha_pair(i)),
                                   rtol=0, atol=0)
        for tfn, jfn, pair in ((t_sch.ddim_step, j_sch.ddim_step, a),
                               (t_sch.ddim_inverse_step,
                                j_sch.ddim_inverse_step, b)):
            got = tfn(torch.from_numpy(x), torch.from_numpy(eps), *pair)
            want = jfn(jnp.asarray(x), jnp.asarray(eps),
                       jnp.float32(pair[0]), jnp.float32(pair[1]))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("n_padded,chunk_ord,merge_global", [
    (8, "mix-4", True), (32, "mix-4", True), (16, "rand", True),
    (12, "seq", True), (16, "mix-3", False)])
def test_chunk_table_identical(n_padded, chunk_ord, merge_global):
    order, div = t_chunk.parse_chunk_ord(chunk_ord)
    assert (order, div) == j_chunk.parse_chunk_ord(chunk_ord)
    got = t_chunk.build_fidx_table(n_padded, 4, np.random.default_rng(7), 9,
                                   chunk_ord=order, perm_div=div,
                                   merge_global=merge_global)
    want = j_chunk.build_fidx_table(n_padded, 4, np.random.default_rng(7), 9,
                                    chunk_ord=order, perm_div=div,
                                    merge_global=merge_global)
    np.testing.assert_array_equal(got, want)
    for n in (5, 8, 13):
        got_p = t_chunk.pad_to_chunks(n, 4)
        want_p = j_chunk.pad_to_chunks(n, 4)
        assert got_p[0] == want_p[0]
        np.testing.assert_array_equal(got_p[1], want_p[1])


@pytest.mark.parametrize("vocab,length", [(1000, 16), (49408, 77)])
def test_hash_tokenizer_identical(vocab, length):
    prompts = ["a sun over rolling green hills with a red bouncing ball.",
               "", "Watercolor  painting &amp; more, (ok)!"]
    got = t_tok.load_tokenizer(None, vocab, length)(prompts)
    want = j_tok.load_tokenizer(None, vocab, length)(prompts)
    np.testing.assert_array_equal(got, want)


def test_bpe_tokenizer_identical(tmp_path):
    import json

    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1, "a</w>": 2, "b": 3,
             "c</w>": 4, "bc</w>": 5, "ab": 6, "!</w>": 7}
    (tmp_path / "tokenizer").mkdir()
    (tmp_path / "tokenizer" / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "tokenizer" / "merges.txt").write_text(
        "#version: 0.2\nb c</w>\na b\n")
    prompts = ["a bc abc!", "A  B C"]
    got = t_tok.load_tokenizer(str(tmp_path), max_length=12)(prompts)
    want = j_tok.load_tokenizer(str(tmp_path), max_length=12)(prompts)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim", [32, 320])
def test_timestep_embedding(dim):
    # sin/cos of arguments up to t = 981 rad: one fp32 ulp of the argument
    # (6e-5 there) separates the two libraries' exp, so atol is 2e-4
    t = np.array([1, 421, 981])
    np.testing.assert_allclose(t_temb(torch.from_numpy(t), dim).numpy(),
                               np.asarray(j_temb(jnp.asarray(t), dim)),
                               atol=2e-4, rtol=0)
