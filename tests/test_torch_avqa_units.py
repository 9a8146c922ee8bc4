"""The AVQA slice's pieces against the JAX package, on the CPU in float32:
the LSTM question encoder and the question-as-query attention block, each
with the gradients of its parameters (and inputs), the loss and the
accuracy of a train step (the JAX `make_avqa_loss_fn` itself, over given
outputs), `AVQAAccuracy`, and the attention-weight dropout mask shared by
every batch row and head as flax draws it. Module variables are seeded
noise (`torch_port_harness`).

Tolerances: activations and gradients rtol 2e-3 with an atol of 1e-4 of the
largest reference value; losses rtol 5e-3.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_port_harness import jax_variables, to_jax

from avmoe_tpu_torch.convert import export_jax_variables, load_jax_variables

torch.set_num_threads(2)


def _close(ours, ref, what=""):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    atol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=atol, err_msg=what)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.array(v)
    return out


def _param_grads(model):
    """The port's parameter gradients as a flax tree (each gradient moved
    into its parameter for the export)."""
    params = dict(model.named_parameters())
    saved = {n: p.detach().clone() for n, p in params.items()}
    with torch.no_grad():
        for p in params.values():
            p.copy_(torch.zeros_like(p) if p.grad is None else p.grad)
        out = _flat(export_jax_variables(model)["params"])
        for n, p in params.items():
            p.copy_(saved[n])
    return out


def _compare(j_fn, variables, t_module, t_fn, inputs, float_inputs):
    """Output and the gradients of <out, cot> wrt every parameter and every
    float input; inputs[i] is differentiated where float_inputs[i]."""
    load_jax_variables(t_module, variables)
    t_module.zero_grad(set_to_none=True)
    diff = [i for i, f in enumerate(float_inputs) if f]

    def j_loss(params, *xs):
        full = list(inputs)
        for i, x in zip(diff, xs):
            full[i] = x
        return j_fn(dict(variables, params=params), *full)

    j_out, vjp = jax.vjp(j_loss, to_jax(variables["params"]),
                         *(jnp.asarray(inputs[i]) for i in diff))
    cot = np.random.RandomState(9).randn(*j_out.shape).astype(np.float32)
    j_grads = vjp(jnp.asarray(cot))
    tx = [torch.from_numpy(np.array(x)).requires_grad_(f) for x, f in zip(inputs, float_inputs)]
    t_out = t_fn(*tx)
    _close(t_out.detach().numpy(), j_out, "output")
    (t_out * torch.from_numpy(cot)).sum().backward()
    for i, g in zip(diff, j_grads[1:]):
        _close(tx[i].grad.numpy(), g, f"input {i} gradient")
    ours, ref = _param_grads(t_module), _flat(j_grads[0])
    assert set(ours) == set(ref)
    for k in ref:
        _close(ours[k], ref[k], "/".join(k) + " gradient")
    return np.asarray(j_out), t_out.detach()


# (vocab, word_embed, hidden, embed, B, L): the tiny config's, and one where
# the embedding and hidden widths differ
QST_SHAPES = [(20, 16, 16, 128, 3, 6), (93, 24, 40, 32, 2, 30)]


@pytest.mark.parametrize("vocab,we,hid,emb,B,L", QST_SHAPES, ids=["tiny", "full length"])
def test_question_encoder_matches_jax_with_gradients(vocab, we, hid, emb, B, L):
    """Embedding, tanh, the LSTM over the whole padded question, tanh([h, c]),
    fc: the output and every parameter's gradient (the embedding rows of the
    tokens used, the per-gate LSTM kernels, fc)."""
    from avmoe_tpu.models.avqa import QstEncoder as JQst

    from avmoe_tpu_torch.models.avqa import QstEncoder

    q = np.random.RandomState(1).randint(0, vocab, (B, L)).astype(np.int32)
    jm = JQst(vocab, we, hid, emb)
    variables = jax_variables(jm, jnp.asarray(q), seed=2)
    pm = QstEncoder(vocab, we, hid, emb)
    _compare(lambda v, x: jm.apply(v, x), variables, pm, pm, [q], [False])


def test_question_encoder_concatenates_h_then_c():
    """flax's carry is (c, h); the feature is [h, c]. A port that took [c, h]
    leaves JAX's output: the same weights with the two halves of fc's input
    swapped give another result."""
    from avmoe_tpu.models.avqa import QstEncoder as JQst

    from avmoe_tpu_torch.models.avqa import QstEncoder

    vocab, we, hid, emb = 20, 16, 16, 32
    q = np.random.RandomState(3).randint(0, vocab, (4, 6)).astype(np.int32)
    jm = JQst(vocab, we, hid, emb)
    variables = jax_variables(jm, jnp.asarray(q), seed=4)
    ref = np.asarray(jm.apply(to_jax(variables), jnp.asarray(q)))
    pm = QstEncoder(vocab, we, hid, emb)
    load_jax_variables(pm, variables)
    with torch.no_grad():
        ours = pm(torch.from_numpy(q)).numpy()
        emb_t = torch.tanh(pm.word2vec(torch.from_numpy(q).long()))
        _, (h, c) = pm.lstm(emb_t, return_carry=True)
        swapped = pm.fc(torch.tanh(torch.cat([c, h], dim=-1))).numpy()
    _close(ours, ref)
    assert np.abs(swapped - ref).max() > 1e-2


def test_query_attention_ffn_matches_jax_with_gradients():
    """4 heads, the question as the single query over the T segments, the
    FFN residual and LayerNorm (eps 1e-5): output and the gradients of the
    question, the sequence and every parameter."""
    from avmoe_tpu.models.avqa import _QueryAttentionFFN as JAttn

    from avmoe_tpu_torch.models.avqa import _QueryAttentionFFN

    rng = np.random.RandomState(5)
    q = rng.randn(3, 32).astype(np.float32)
    kv = rng.randn(3, 10, 32).astype(np.float32)
    jm = JAttn(32)
    variables = jax_variables(jm, jnp.asarray(q), jnp.asarray(kv), seed=6)
    assert set(variables["params"]) == {"attn", "linear1", "linear2", "norm"}
    pm = _QueryAttentionFFN(32)
    _compare(lambda v, a, b: jm.apply(v, a, b), variables, pm, pm, [q, kv], [True, True])


def test_attention_dropout_mask_is_shared_by_batch_rows_and_heads():
    """flax's MHA draws one (queries, keys) dropout mask for every batch row
    and head (broadcast_dropout=True): two identical batch rows give
    identical outputs in train, in both packages, while their masks differ
    from the identity."""
    from avmoe_tpu_torch.heads.common import MultiHeadAttention

    rng = np.random.RandomState(7)
    q = np.repeat(rng.randn(1, 1, 16).astype(np.float32), 2, axis=0)
    kv = np.repeat(rng.randn(1, 12, 16).astype(np.float32), 2, axis=0)
    pm = MultiHeadAttention(16, 4)
    with torch.no_grad():
        for p in pm.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.3))
    tq, tkv = torch.from_numpy(q), torch.from_numpy(kv)
    with torch.no_grad():
        out = pm(tq, tkv, rate=0.5, train=True, generator=torch.Generator().manual_seed(0))
        plain = pm(tq, tkv)
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
    assert (out - plain).abs().max() > 1e-3

    from flax import linen as fnn

    jm = fnn.MultiHeadDotProductAttention(num_heads=4, dropout_rate=0.5, deterministic=False)
    variables = jax_variables(jm, jnp.asarray(q), jnp.asarray(kv), seed=8)
    j_out = np.asarray(jm.apply(to_jax(variables), jnp.asarray(q), jnp.asarray(kv),
                                rngs={"dropout": jax.random.PRNGKey(1)}))
    np.testing.assert_array_equal(j_out[0], j_out[1])


class _GivenOutputs:
    """Stands in for the JAX model in `make_avqa_loss_fn`: apply returns the
    given outputs."""

    def __init__(self, out, answer_vocab):
        from avmoe_tpu.config import AVQAConfig

        self.out = out
        self.cfg = AVQAConfig(answer_vocab=answer_vocab)

    def apply(self, variables, *args, **kwargs):
        return self.out, {"batch_stats": {}}


def test_avqa_loss_and_accuracy_match_jax():
    """CE(answer) + 0.5 CE(match), the positive rows labelled 1 and the
    negative rows 0, and the accuracy over the first answer_vocab of the
    fc_class logits (an argmax beyond them does not count)."""
    from avmoe_tpu.models.avqa import make_avqa_loss_fn as j_loss_fn

    from avmoe_tpu_torch.models.avqa import avqa_loss

    rng = np.random.RandomState(10)
    B, T, vocab, fc_class = 6, 10, 42, 50
    logits = rng.randn(B, fc_class).astype(np.float32)
    logits[0, 45] = 10.0                     # argmax outside the answer vocab
    answer = rng.randint(0, vocab, B).astype(np.int32)
    answer[1] = int(np.argmax(logits[1, :vocab]))
    out = {"qa_logits": logits, "match_posi": rng.randn(B * T, 2).astype(np.float32),
           "match_nega": rng.randn(B * T, 2).astype(np.float32), "telemetry": {}}
    fake = _GivenOutputs({k: jnp.asarray(v) if k != "telemetry" else v
                          for k, v in out.items()}, vocab)
    batch = {"wave": jnp.zeros((B, T, 4)), "visual_posi": None, "visual_nega": None,
             "question": None, "answer": jnp.asarray(answer)}
    j_loss, (j_aux, _) = j_loss_fn(fake)(None, batch, {})
    loss, aux = avqa_loss({k: torch.from_numpy(v) if k != "telemetry" else v
                           for k, v in out.items()}, torch.from_numpy(answer), vocab)
    assert float(loss) == pytest.approx(float(j_loss), rel=5e-3)
    assert set(aux) == set(j_aux)
    for k in j_aux:
        assert float(aux[k]) == pytest.approx(float(j_aux[k]), rel=5e-3), k
    assert float(aux["accuracy"]) == pytest.approx(100.0 * np.mean(
        np.argmax(logits[:, :vocab], -1) == answer))


def test_avqa_accuracy_matches_jax_per_question_type():
    from avmoe_tpu.metrics.avqa import AVQAAccuracy as JAccuracy

    from avmoe_tpu_torch.metrics.avqa import AVQAAccuracy

    rng = np.random.RandomState(11)
    types = ["Audio_Counting", "Visual_Location", "Audio-Visual_Existential", ""]
    ours, ref = AVQAAccuracy(), JAccuracy()
    for _ in range(3):
        pred, answer = rng.randint(0, 4, 16), rng.randint(0, 4, 16)
        qt = [types[i] for i in rng.randint(0, 4, 16)]
        ours.update(pred, answer, qt)
        ref.update(pred, answer, qt)
    assert ours.summary() == ref.summary()
    assert set(ours.summary()) == {"overall"} | set(types[:3])
