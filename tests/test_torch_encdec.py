"""The port's encoder-decoder model (whisper-tiny) and the vision prefix
against the JAX package's, with the same weights and inputs.

Weights come from the reference's own init (``jax.random.PRNGKey(0)``) and
are carried over by :mod:`repro_torch.bridge`; inputs are drawn by numpy
from a seed.  Reduced whisper-tiny (``reduce_cfg``) is 2 encoder and 2
decoder layers of d_model 128, 4 heads of 32, vocab 512.  The reference's
init draws every stacked leaf at its layers axis' fan-in (2 here, so std
0.71 on every projection), where float32 rounding alone moves the encoder
output and the logits by ~2e-4 from the port's own float64 run (JAX's
float32 by the same).  So the parity tests run on that init with every
stacked leaf scaled to one layer's fan-in (``chip_smoke._layer_fan_in``,
phase 41's gated float32 set; the same arrays in both packages), where the
float32 floor is ~2e-6, at TOL; one test holds both packages' float32 to
the port's float64 run at the raw init within RAW_TOL.

Reduced internvl2-76b (2 layers, one stacked segment, the same weights at
one layer's fan-in) takes 8 stub patch tokens: ``loss`` with its grads and
``prefill`` through ``make_prefill_step``, against the reference.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs files in parallel workers
torch.set_num_threads(1)

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.configs import ARCHS as JARCHS                    # noqa: E402
from repro.configs import reduce_cfg as jreduce              # noqa: E402
from repro.kernels.flash_attention import kernel as jkernel  # noqa: E402
from repro.kernels.flash_attention import ops as jfa         # noqa: E402
from repro.kernels.flash_attention import ref as jref        # noqa: E402
from repro.models import build_model as jbuild               # noqa: E402
from repro.models.common import sinusoid_positions as jsinusoid  # noqa: E402
from repro.train.step import make_prefill_step as jprefill_step  # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch.configs import ARCHS, reduce_cfg            # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa   # noqa: E402
from repro_torch.models import EncDecLM, build_model         # noqa: E402
from repro_torch.models import attention as tattention       # noqa: E402
from repro_torch.models.common import sinusoid_positions     # noqa: E402
from repro_torch.train import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.tree import tree_map                        # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
import chip_smoke                                            # noqa: E402

WHISPER, INTERNVL = "whisper-tiny", "internvl2-76b"
# float32 on both sides through 2 + 2 layers at one layer's fan-in: the
# floor is ~2e-6 (the port's float64 run against either float32 run)
TOL = 1e-4
# at the reference's raw init each float32 run sits up to ~2.3e-4 from the
# port's float64 run (encoder output ~3.8, logits ~4.2 at most)
RAW_TOL = 1e-3
B, S, S_ENC, L = 2, 20, 40, 64
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _models(raw=False):
    jcfg = jreduce(JARCHS[WHISPER].cfg)
    cfg = reduce_cfg(ARCHS[WHISPER].cfg)
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg)
    bridge.params_from_jax_numpy(jax.tree.map(np.asarray, jparams), tm,
                                 "cpu")
    if not raw:
        chip_smoke._layer_fan_in(tm)
        jparams = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tm))
    return jm, jparams, tm


@pytest.fixture(scope="module")
def models():
    return _models()


def _inputs(cfg, seed=0, b=B, s=S, s_enc=S_ENC):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, s_enc, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    return frames, toks, np.roll(toks, -1, axis=1)


def _pos(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                           (b, s)).copy()


def _close(got, want, tol=TOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=err_msg)


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("length,dim", [(1, 384), (7, 10), (1500, 384),
                                        (32768, 384), (300, 128)])
def test_sinusoid_positions_bit_equal(length, dim):
    got = sinusoid_positions(length, dim)
    want = np.asarray(jsinusoid(length, dim))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert got.numpy().tobytes() == want.tobytes()


def test_decoder_position_table_is_built_once(models):
    """The decoder's max_target_length x d table is a buffer built when the
    parameters are set and equal to the reference's; the encoder's is a
    buffer built for the first call's frame count and kept while the count
    stays, rebuilt when it changes."""
    _, _, tm = models
    m = build_model(tm.cfg).set_params(tm.params.to_dict())
    d = m.cfg.d_model
    assert tuple(m.dec_positions.shape) == (m.cfg.max_target_length, d)
    assert torch.equal(m.dec_positions,
                       sinusoid_positions(m.cfg.max_target_length, d))
    assert m.enc_positions is None
    with torch.no_grad():
        for s_enc, fresh in ((S_ENC, True), (S_ENC, False),
                             (S_ENC + 3, True)):
            before = m.enc_positions
            m.encode(torch.zeros(1, s_enc, d))
            assert (m.enc_positions is not before) == fresh
            assert m.enc_positions.numpy().tobytes() == np.asarray(
                jsinusoid(s_enc, d)).tobytes()
    assert {"dec_positions", "enc_positions"} <= set(dict(
        m.named_buffers()))


# ----------------------------------------------------------- specs, bridge
def test_specs_and_paths_match():
    jm, _, tm = _models(raw=True)
    assert isinstance(tm, EncDecLM)

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            return {p: v for k in tree for p, v in
                    flat(tree[k], prefix + (k,)).items()}
        return {prefix: (tuple(tree.shape), tuple(tree.axes), tree.init,
                         tree.scale)}
    assert flat(tm.param_specs()) == flat(jm.param_specs())
    jc = jm.cache_specs(B, L)
    tc = tm.cache_specs(B, L)
    assert {k: (v.shape, v.axes) for k, v in tc.items()} == {
        k: (v.shape, v.axes) for k, v in jc.items()}


def test_bridge_round_trips_exactly(models):
    _, jparams, tm = models
    back = bridge.params_to_numpy(tm)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_j:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_bridge_carries_the_encdec_state_exactly(models):
    """The reference's prefill state ``(caches, (k, v))`` goes over and
    back bit for bit, tuples kept."""
    jm, jparams, tm = models
    frames, toks, _ = _inputs(tm.cfg, seed=5)
    _, state = jax.jit(jm.prefill)(jparams, jnp.asarray(toks),
                                   jm.init_cache(B, L),
                                   frame_embeds=jnp.asarray(frames))
    jstate = jax.tree.map(np.asarray, state)
    tstate = bridge.cache_from_jax_numpy(jstate, "cpu")
    assert isinstance(tstate, tuple) and isinstance(tstate[1], tuple)
    assert isinstance(tstate[1][0], torch.Tensor)
    assert tstate[0]["pos"].dtype == torch.int32
    back = bridge.cache_to_numpy(tstate)
    assert (jax.tree.structure(back) == jax.tree.structure(jstate))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------- encode / decode
def test_encode_and_teacher_forced_decode_match(models):
    jm, jparams, tm = models
    frames, toks, _ = _inputs(tm.cfg)
    jenc = jax.jit(jm.encode)(jparams, jnp.asarray(frames))
    jlg, _, jkv = jax.jit(lambda p, t, e, pos: jm.decode(
        p, t, e, positions=pos))(jparams, jnp.asarray(toks), jenc,
                                 jnp.asarray(_pos(B, S)))
    with torch.no_grad():
        tenc = tm.encode(torch.from_numpy(frames))
        tlg, caches, tkv = tm.decode(torch.from_numpy(toks).long(), tenc,
                                     positions=torch.from_numpy(_pos(B, S)))
    assert caches is None
    _close(tenc.numpy(), jenc, err_msg="encode")
    _close(tlg.numpy(), jlg, err_msg="logits")
    for a, b in zip(tkv, jkv):
        assert tuple(a.shape) == b.shape == (tm.cfg.n_layers, B, S_ENC,
                                             tm.cfg.n_kv_heads, tm.cfg.hd)
        _close(a.numpy(), b, err_msg="cross_kv")


def test_raw_init_within_float32_noise():
    """At the reference's raw init (std 0.71 on every stacked leaf) the
    port's float32 and JAX's float32 each stay within RAW_TOL of the
    port's float64 run, encoder output and logits."""
    jm, jparams, tm = _models(raw=True)
    frames, toks, _ = _inputs(tm.cfg, seed=6)
    m64 = build_model(tm.cfg.replace(dtype="float64")).set_params(
        tree_map(lambda t: t.detach().double(), tm.params.to_dict()))
    jenc = np.asarray(jax.jit(jm.encode)(jparams, jnp.asarray(frames)))
    jlg = np.asarray(jax.jit(lambda p, t, e, pos: jm.decode(
        p, t, e, positions=pos)[0])(jparams, jnp.asarray(toks),
                                    jnp.asarray(jenc),
                                    jnp.asarray(_pos(B, S))))
    pos = torch.from_numpy(_pos(B, S))
    with torch.no_grad():
        tenc = tm.encode(torch.from_numpy(frames))
        tlg = tm.decode(torch.from_numpy(toks).long(), tenc,
                        positions=pos)[0]
        enc64 = m64.encode(torch.from_numpy(frames).double())
        lg64 = m64.decode(torch.from_numpy(toks).long(), enc64,
                          positions=pos)[0]
    for name, got in (("port", (tenc.numpy(), tlg.numpy())),
                      ("jax", (jenc, jlg))):
        _close(got[0], enc64.numpy(), RAW_TOL, f"{name} encode")
        _close(got[1], lg64.numpy(), RAW_TOL, f"{name} logits")


def test_loss_and_grads_match(models):
    """The loss and every leaf's gradient (the flash wrapper's
    autograd.Function on the encoder's and the decoder's self-attention
    included), also after a forward without autograd has run."""
    jm, jparams, tm = models
    frames, toks, labels = _inputs(tm.cfg, seed=2)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              "frame_embeds": jnp.asarray(frames)}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jbatch), has_aux=True))(jparams)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long(),
             "frame_embeds": torch.from_numpy(frames)}
    with torch.no_grad():
        tm.loss(batch)
    tm.zero_grad(set_to_none=True)
    before = tfa.plain_calls
    tl, tmet = tm.loss(batch)
    tl.backward()
    # one flash call a layer of each stack (no remat in the reduced config)
    assert tfa.plain_calls == before + 2 * tm.cfg.n_layers
    _close(float(tl.detach()), float(jl), err_msg="loss")
    assert set(tmet) == set(jmet) == {"ce"}
    tg = jax.tree.map(lambda p: p.grad, tm.params.to_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jg):
        node = tg
        for k in path:
            node = node[k.key]
        _close(node.numpy(), leaf, err_msg=str(path))


def test_prefill_state_and_decode_steps_match(models):
    """``prefill`` (through ``make_prefill_step``, frames to the encoder):
    its last logits and its ``(caches, cross_kv)`` state; then 6 greedy
    ``decode_step``s (through ``make_serve_step``): logits and tokens."""
    jm, jparams, tm = models
    frames, toks, _ = _inputs(tm.cfg, seed=1)
    jlog, jstate = jax.jit(jprefill_step(jm, max_len=L))(
        jparams, {"tokens": jnp.asarray(toks),
                  "frame_embeds": jnp.asarray(frames)})
    before = tfa.plain_calls
    with torch.inference_mode():
        tlog, tstate = make_prefill_step(tm, max_len=L)(
            torch.from_numpy(toks).long(),
            frame_embeds=torch.from_numpy(frames))
    # the encoder's and the decoder's self-attention, one call a layer
    assert tfa.plain_calls == before + 2 * tm.cfg.n_layers
    assert tlog.shape == (B, 1, tm.cfg.vocab)
    _close(tlog.numpy(), jlog, err_msg="prefill logits")
    got = bridge.cache_to_numpy(tstate)
    assert jax.tree.structure(got) == jax.tree.structure(jstate)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jstate):
        node = got
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        _close(node, leaf, err_msg=f"state {path}")
    jstep = jax.jit(jm.decode_step)
    serve_step = make_serve_step(tm)
    jtok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tlog[:, -1], -1)[:, None].to(torch.int32)
    for i in range(6):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        pos = np.full((B, 1), S + i, np.int32)
        jlog, jstate = jstep(jparams, jstate, jtok, jnp.asarray(pos))
        before = tfa.plain_calls
        with torch.inference_mode():
            tlog, tstate = tm.decode_step(tstate, ttok.long(),
                                          torch.from_numpy(pos))
            nxt, _ = serve_step(tstate, ttok.long(), torch.from_numpy(pos))
        assert tfa.plain_calls == before       # decode: no flash call
        _close(tlog.numpy(), jlog, err_msg=f"decode step {i}")
        jtok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tlog[:, -1], -1)[:, None].to(torch.int32)
        # serve_step re-wrote the same slot with the same K/V: its token
        # is the step's
        assert torch.equal(nxt, ttok)


def test_prefill_refuses_used_caches_and_long_prompts(models):
    _, _, tm = models
    frames, toks, _ = _inputs(tm.cfg, seed=3)
    fr, tk = torch.from_numpy(frames), torch.from_numpy(toks).long()
    with torch.inference_mode():
        _, (caches, _) = tm.prefill(tk, tm.init_cache(B, L), frame_embeds=fr)
        with pytest.raises(ValueError, match="empty cache"):
            tm.prefill(tk, caches, frame_embeds=fr)
        with pytest.raises(ValueError, match="do not fit"):
            tm.prefill(tk, tm.init_cache(B, S - 1), frame_embeds=fr)
        with pytest.raises(ValueError, match="frame_embeds"):
            tm.prefill(tk, tm.init_cache(B, L))


def test_decode_takes_row_zeros_positions(models):
    """Rows at different positions: every row adds the sinusoid rows of
    row 0's positions, in both packages.  Two prompts of 12 and 17 tokens
    are prefilled alone and their states joined into one batch; a
    decode step of that batch at positions 12 and 17 matches the
    reference's, and its row 1 differs from row 1 decoded alone at its
    own position 17 (where both packages agree too)."""
    jm, jparams, tm = models
    frames, toks, _ = _inputs(tm.cfg, seed=4)
    lens = (12, 17)
    states = []
    for r, n in enumerate(lens):
        _, st = jax.jit(jm.prefill)(jparams, jnp.asarray(toks[r:r + 1, :n]),
                                    jm.init_cache(1, L),
                                    frame_embeds=jnp.asarray(
                                        frames[r:r + 1]))
        states.append(jax.tree.map(np.asarray, st))
    (c0, (k0, v0)), (c1, (k1, v1)) = states
    joined = ({k: np.concatenate([c0[k], c1[k]], axis=1) for k in c0},
              (np.concatenate([k0, k1], axis=1),
               np.concatenate([v0, v1], axis=1)))
    tok = toks[:, 19:20]
    pos = np.array([[lens[0]], [lens[1]]], np.int32)
    jlog, _ = jax.jit(jm.decode_step)(jparams,
                                      jax.tree.map(jnp.asarray, joined),
                                      jnp.asarray(tok), jnp.asarray(pos))
    alone = jax.tree.map(jnp.asarray, states[1])
    jalone, _ = jax.jit(jm.decode_step)(jparams, alone, jnp.asarray(tok[1:]),
                                        jnp.asarray(pos[1:]))
    with torch.inference_mode():
        tlog, _ = tm.decode_step(bridge.cache_from_jax_numpy(joined, "cpu"),
                                 torch.from_numpy(tok).long(),
                                 torch.from_numpy(pos))
        talone, _ = tm.decode_step(
            bridge.cache_from_jax_numpy(states[1], "cpu"),
            torch.from_numpy(tok[1:]).long(), torch.from_numpy(pos[1:]))
    _close(tlog.numpy(), jlog, err_msg="joined batch")
    _close(talone.numpy(), jalone, err_msg="row 1 alone")
    # row 0 is at its own position either way; row 1 is not
    assert float(np.abs(tlog[1].numpy() - talone[0].numpy()).max()) > 100 * TOL
    assert float(np.abs(np.asarray(jlog[1]) - np.asarray(jalone[0])).max()
                 ) > 100 * TOL


# ------------------------------------------------------------ remat, routes
def test_remat_full_and_dots_equal_none(models):
    """Under "full" (and "dots", which the reference treats as "full" on
    this model) every encoder and decoder layer recomputes in the
    backward: the loss and every grad equal remat "none"'s bit for bit,
    and the flash wrapper's calls double."""
    _, _, tm = models
    frames, toks, labels = _inputs(tm.cfg, seed=7)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long(),
             "frame_embeds": torch.from_numpy(frames)}
    out = {}
    for remat in ("none", "full", "dots"):
        m = build_model(tm.cfg.replace(remat=remat)).set_params(
            tree_map(lambda t: t.detach().clone(), tm.params.to_dict()))
        before = tfa.plain_calls
        loss, _ = m.loss(batch)
        loss.backward()
        out[remat] = (loss.detach(), tfa.plain_calls - before,
                      [p.grad for p in m.parameters()])
    n = 2 * tm.cfg.n_layers
    assert out["none"][1] == n
    for remat in ("full", "dots"):
        assert out[remat][1] == 2 * n, remat
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][2], out["none"][2]):
            assert torch.equal(a, b), remat


@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
def test_encoder_attention_goes_through_flash_non_causal(models, monkeypatch,
                                                         attn_impl):
    """Under ``attn_impl="kernel"`` the loss sends each encoder layer's
    attention to ``flash_attention`` with ``causal=False`` and each
    decoder layer's with ``causal=True``; under "ref" none, and the two
    losses agree."""
    _, _, tm = models
    calls = []
    sound = tattention.flash_ops.flash_attention

    def recording(q, k, v, **kw):
        calls.append(kw["causal"])
        return sound(q, k, v, **kw)
    monkeypatch.setattr(tattention.flash_ops, "flash_attention", recording)
    frames, toks, labels = _inputs(tm.cfg, seed=8)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long(),
             "frame_embeds": torch.from_numpy(frames)}
    m = build_model(tm.cfg.replace(attn_impl=attn_impl)).set_params(
        tm.params.to_dict())
    with torch.no_grad():
        loss, _ = m.loss(batch)
        want, _ = build_model(tm.cfg.replace(attn_impl="ref")).set_params(
            tm.params.to_dict()).loss(batch)
    n = tm.cfg.n_layers
    assert calls == ([False] * n + [True] * n if attn_impl == "kernel"
                     else [])
    _close(float(loss), float(want))


def test_planted_faults_move_the_plain_path(models):
    """The faults phase 41 plants in the plain path (``chip_smoke.
    encdec_fault``): the encoder run causal, and each decoder layer's
    cross K/V taken from the layer before; each moves the prefill's last
    logits far past TOL from the sound plain path, which matches the
    kernel route."""
    _, _, tm = models
    plain = build_model(tm.cfg.replace(attn_impl="ref")).set_params(
        tm.params.to_dict())
    frames, toks, _ = _inputs(tm.cfg, seed=9, b=1)

    def last(m):
        with torch.inference_mode():
            lg, _ = make_prefill_step(m, max_len=L)(
                torch.from_numpy(toks).long(),
                frame_embeds=torch.from_numpy(frames))
        return lg[0, -1]
    want = last(plain)
    _close(last(tm).numpy(), want.numpy())
    for fault in chip_smoke.ENCDEC_FAULTS:
        with chip_smoke.encdec_fault(fault):
            got = last(plain)
        assert float((got - want).abs().max()) > 100 * TOL, fault
    assert torch.equal(last(plain), want)          # every fault removed


# ---------------------------------------------------------- non-causal flash
def _fa_inputs(S_, H, D, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((1, S_, H, D), dtype=np.float32)
            for _ in range(3)]
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


@pytest.mark.parametrize("S_,dtype", [(256, "float32"), (256, "bfloat16"),
                                      (100, "float32")])
def test_plain_non_causal_flash_matches_jax(S_, dtype):
    """The wrapper's plain version with ``causal=False`` against the
    reference's oracle ``attention_ref(causal=False)``, and at S=256 (the
    TPU kernel's lengths) against its Pallas kernel in interpret mode."""
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    (jq, jk, jv), (q, k, v) = _fa_inputs(S_, 6, 64, dtype, seed=S_)
    kw = dict(scale=64 ** -0.5, causal=False)
    before = tfa.plain_calls
    out = tfa.flash_attention(q, k, v, **kw)
    assert tfa.plain_calls == before + 1
    jt = [jnp.swapaxes(t, 1, 2) for t in (jq, jk, jv)]
    want = jnp.swapaxes(jref.attention_ref(*jt, **kw), 1, 2)
    _close(out.float().numpy(), np.asarray(want, np.float32), tol)
    if S_ % 128 == 0:
        pallas = jnp.swapaxes(jkernel.flash_attention_fwd(
            *jt, interpret=True, **kw), 1, 2)
        _close(out.float().numpy(), np.asarray(pallas, np.float32), tol)
    # causal=True is another function on these inputs
    causal = tfa.flash_attention(q, k, v, scale=kw["scale"], causal=True)
    assert float((causal.float() - out.float()).abs().max()) > 100 * tol


def test_non_causal_flash_grad_matches_jax():
    """The wrapper's backward recomputes with the call's causal flag: its
    non-causal grads equal ``jax.grad`` of the reference's wrapper."""
    (jq, jk, jv), (q, k, v) = _fa_inputs(256, 2, 64, "float32", seed=11)
    scale = 64 ** -0.5
    gj = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(
        q, k, v, scale=scale, causal=False) ** 2), argnums=(0, 1, 2))(
            jq, jk, jv)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    torch.sum(tfa.flash_attention(q, k, v, scale=scale,
                                  causal=False) ** 2).backward()
    for a, b in zip((q.grad, k.grad, v.grad), gj):
        _close(a.numpy(), b)


# ------------------------------------------------------------ vision prefix
@pytest.fixture(scope="module")
def vision():
    jcfg = jreduce(JARCHS[INTERNVL].cfg).replace(n_frontend_tokens=8)
    cfg = reduce_cfg(ARCHS[INTERNVL].cfg).replace(n_frontend_tokens=8)
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg)
    bridge.params_from_jax_numpy(jax.tree.map(np.asarray, jparams), tm,
                                 "cpu")
    # its 2 layers are one stacked segment: at the raw init the embedding
    # grad (largest 6.5) moves by 1.3e-3 between JAX's float32 and the
    # port's float64; at one layer's fan-in by 1e-7
    chip_smoke._layer_fan_in(tm)
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tm))
    return jm, jparams, tm


def _vision_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    patches = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    return toks, np.roll(toks, -1, axis=1), patches


def test_vision_prefix_loss_and_grads_match(vision):
    """Reduced internvl2-76b with 8 patch tokens: the loss (positions over
    8 + S, the prefix's hidden rows dropped) and every grad."""
    jm, jparams, tm = vision
    toks, labels, patches = _vision_batch(tm.cfg, seed=0)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              "patch_embeds": jnp.asarray(patches)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jbatch), has_aux=True))(jparams)
    tm.zero_grad(set_to_none=True)
    tl, _ = tm.loss({"tokens": torch.from_numpy(toks).long(),
                     "labels": torch.from_numpy(labels).long(),
                     "patch_embeds": torch.from_numpy(patches)})
    tl.backward()
    _close(float(tl.detach()), float(jl), err_msg="loss")
    tg = jax.tree.map(lambda p: p.grad, tm.params.to_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jg):
        node = tg
        for k in path:
            node = node[k.key]
        _close(node.numpy(), leaf, err_msg=str(path))


def test_vision_prefix_prefill_matches(vision):
    """``make_prefill_step`` with ``patch_embeds``: the default cache is
    P + S long, and the last logits and the caches match the
    reference's; a cache of S alone is refused."""
    jm, jparams, tm = vision
    toks, _, patches = _vision_batch(tm.cfg, seed=1)
    jlog, jcache = jax.jit(jprefill_step(jm))(
        jparams, {"tokens": jnp.asarray(toks),
                  "patch_embeds": jnp.asarray(patches)})
    with torch.inference_mode():
        tlog, tcache = make_prefill_step(tm)(
            torch.from_numpy(toks).long(),
            patch_embeds=torch.from_numpy(patches))
        with pytest.raises(ValueError, match="do not fit"):
            make_prefill_step(tm, max_len=S)(
                torch.from_numpy(toks).long(),
                patch_embeds=torch.from_numpy(patches))
    _close(tlog.numpy(), jlog, err_msg="prefill logits")
    got = bridge.cache_to_numpy(tcache)
    assert got[0][0]["pos"].shape[-1] == S + 8
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jcache)):
        assert a.shape == b.shape
        _close(a, b)


def test_importing_encdec_loads_no_jax():
    code = ("import sys, repro_torch.models.encdec; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
