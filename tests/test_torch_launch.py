"""The port's launchers (``repro_torch.launch``) against the reference's
(``repro.launch``).

The dry-run's cells are held to the reference's cells built on a
``jax.sharding.AbstractMesh`` (the reference's ``build_cell`` lowers
nothing, so it needs no device): parameter counts, microbatch clamps,
every argument's spec and the arguments' shard bytes.  The serve and
train CLIs' loops are held to the reference CLIs' loops on reduced
gemma3-1b in float32 with weights bridged from the reference's init.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import reduce_cfg as ref_reduce_cfg  # noqa: E402
from repro.data import DataCfg as RefDataCfg  # noqa: E402
from repro.data import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.launch import cells as ref_cells  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.optim import OptCfg as RefOptCfg  # noqa: E402
from repro.optim import make_optimizer as ref_make_optimizer  # noqa: E402
from repro.train import make_serve_step as ref_make_serve_step  # noqa: E402
from repro.train import make_train_step as ref_make_train_step  # noqa: E402

from repro_torch.bridge import params_from_jax_numpy  # noqa: E402
from repro_torch.configs import ARCHS, reduce_cfg  # noqa: E402
from repro_torch.data import DataCfg, SyntheticLM  # noqa: E402
from repro_torch.launch import cells, cost, dryrun, mesh  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import OptCfg, make_optimizer  # noqa: E402
from repro_torch.sharding import MeshShape, PartitionSpec  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
ARCH = "gemma3-1b"
# the reference dry-run test's three cells, at its (4, 4) mesh
COST_CELLS = (("gemma3-1b", "train_4k"), ("granite-moe-1b-a400m",
                                          "decode_32k"),
              ("whisper-tiny", "prefill_32k"))
SERVE = dict(B=4, prompt=60, max_new=12)   # decode wraps the window of 64
TRAIN = dict(seq=32, global_batch=4, steps=3)
LOSS_RTOL = 1e-5


def _flat(tree):
    """Leaves in ``jax.tree.leaves`` order: dicts by sorted key, lists and
    tuples in order; a PartitionSpec or a tensor is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _nbytes(x) -> int:
    return int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize


# -------------------------------------------------------- (a) parameters
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_and_state_bytes_equal_the_reference(arch):
    spec = ARCHS[arch]
    model = build_model(spec.cfg)
    ref = ref_build_model(REF_ARCHS[arch].cfg)
    aparams = model.abstract_params()
    assert all(t.is_meta for t in tree_leaves(aparams))
    n = sum(t.numel() for t in tree_leaves(aparams))
    ref_leaves = jax.tree.leaves(ref.abstract_params())
    assert n == sum(int(np.prod(x.shape)) for x in ref_leaves)
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in tree_leaves(aparams)] == [
        (tuple(x.shape), str(x.dtype)) for x in ref_leaves]
    rel = abs(n - spec.published_params) / spec.published_params
    assert rel < spec.param_tolerance, (arch, n, rel)
    for name in ("adamw", "adamw8"):
        st = make_optimizer(OptCfg(name=name)).abstract_state(aparams)
        ref_st = ref_make_optimizer(RefOptCfg(name=name)).abstract_state(
            ref.abstract_params())
        assert all(t.is_meta for t in tree_leaves(st))
        assert (sum(t.numel() * t.element_size() for t in tree_leaves(st))
                == sum(_nbytes(x) for x in jax.tree.leaves(ref_st)))
    assert model.abstract_cache(2, 64) is not None


def test_abstract_state_matches_init():
    """``abstract_state`` is ``init``'s tree, dtypes included, on meta."""
    model = build_model(reduce_cfg(ARCHS[ARCH].cfg))
    model.init(torch.Generator().manual_seed(0), "cpu")
    params = model.params.to_dict()
    for name in ("adamw", "adamw8", "adafactor", "sgdm"):
        opt = make_optimizer(OptCfg(name=name, master_fp32=True))
        real, abst = opt.init(params), opt.abstract_state(params)
        assert [(t.shape, t.dtype) for t in tree_leaves(real)] == [
            (t.shape, t.dtype) for t in tree_leaves(abst)]
        assert all(t.is_meta for t in tree_leaves(abst))


# ------------------------------------------------- (b) microbatch clamp
@pytest.mark.parametrize("arch,kw,want", [
    ("granite-moe-1b-a400m", {}, 4),       # 256 / 4 = 64 >= 32: kept
    ("deepseek-v3-671b", {}, 8),           # 256 / 32 = 8 < 32: clamped
    ("deepseek-v3-671b", {"microbatches": 32}, 32),   # explicit: kept
])
def test_microbatch_clamp_respects_dp_extent(arch, kw, want):
    cell = cells.build_cell(arch, "train_4k", MeshShape((2, 16, 2)), **kw)
    ref = ref_cells.build_cell(arch, "train_4k",
                               AbstractMesh((2, 16, 2),
                                            ("pod", "data", "model")), **kw)
    assert cell.meta["microbatches"] == want == ref.meta["microbatches"]


# ------------------------------------------------------------- (c) cost
@pytest.mark.parametrize("arch,shape", COST_CELLS)
def test_cells_build_and_count_like_the_reference(arch, shape):
    port_mesh = MeshShape((4, 4))
    cell = cells.build_cell(arch, shape, port_mesh)
    ref = ref_cells.build_cell(arch, shape,
                               AbstractMesh((4, 4), ("data", "model")))
    for key, val in ref.meta.items():
        assert cell.meta[key] == val, key
    assert cell.meta["attn_impl"] == "ref"
    assert cell.rules == ref.rules
    # every argument: shape, dtype and spec equal the reference's
    args = _flat(cell.args)
    specs = _flat(cell.in_shardings)
    ref_args = jax.tree.leaves(ref.args)
    ref_specs = jax.tree.leaves(
        ref.in_shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(args) == len(specs) == len(ref_args) == len(ref_specs)
    want_bytes = 0
    for a, s, ra, rs in zip(args, specs, ref_args, ref_specs):
        assert tuple(a.shape) == tuple(ra.shape)
        assert a.element_size() == np.dtype(ra.dtype).itemsize
        assert tuple(s) == tuple(rs.spec)
        want_bytes += (int(np.prod(rs.shard_shape(ra.shape)))
                       * np.dtype(ra.dtype).itemsize)
    got_bytes, n = dryrun.argument_bytes(cell.args, cell.in_shardings,
                                         port_mesh)
    assert (got_bytes, n) == (want_bytes, len(ref_args))
    a = cost.analyze(cell.fn, *cell.args)
    assert a["dot_flops"] > 0 and a["flops"] > a["dot_flops"]
    assert a["mem_bytes"] >= a["mem_bytes_out"] > 0


def test_cost_counts_chained_matmuls():
    """As the reference's synthetic HLO: five 8x8 float32 products."""
    def five(x):
        for _ in range(5):
            x = x @ x
        return x
    a = cost.analyze(five, torch.empty(8, 8, device="meta"))
    assert a["dot_flops"] == 5 * 2 * 8 * 8 * 8
    assert a["mem_bytes_out"] == 5 * 8 * 8 * 4
    assert a["mem_bytes"] == 5 * 3 * 8 * 8 * 4
    assert a["counts"].startswith("global")


def test_meshes():
    assert mesh.make_production_mesh() == MeshShape((16, 16),
                                                    ("data", "model"))
    assert mesh.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    host = mesh.make_host_mesh()
    assert host.axis_names == ("data",)
    assert host.dims == (torch.cuda.device_count(),)


# ------------------------------------------------- (d) the serve CLI
def _ref_model(B_total=None):
    cfg = ref_reduce_cfg(REF_ARCHS[ARCH].cfg)
    if B_total is not None:
        cfg = cfg.replace(max_target_length=max(cfg.max_target_length,
                                                B_total))
    model = ref_build_model(cfg)
    return model, model.init(jax.random.PRNGKey(0))


def _port_model(ref_params, total=None):
    cfg = reduce_cfg(ARCHS[ARCH].cfg)
    if total is not None:
        cfg = cfg.replace(max_target_length=max(cfg.max_target_length,
                                                total))
    return params_from_jax_numpy(jax.tree.map(np.asarray, ref_params),
                                 build_model(cfg), "cpu")


def test_generate_equals_the_reference_cli_loop():
    B, P, new = SERVE["B"], SERVE["prompt"], SERVE["max_new"]
    total = P + new
    rmodel, rparams = _ref_model(total)
    tokens = np.random.default_rng(0).integers(
        0, rmodel.cfg.vocab, (B, P)).astype(np.int32)
    # repro/launch/serve.py's loop
    caches = rmodel.init_cache(B, total)
    logits, caches = jax.jit(rmodel.prefill)(rparams, jnp.asarray(tokens),
                                             caches)
    nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    step = jax.jit(ref_make_serve_step(rmodel))
    pos = jnp.full((B, 1), P, jnp.int32)
    want = [nxt]
    for _ in range(new - 1):
        nxt, caches = step(rparams, caches, nxt, pos)
        pos = pos + 1
        want.append(nxt)
    want = np.concatenate([np.asarray(t) for t in want], axis=1)

    model = _port_model(rparams, total)
    times = {}
    got = serve_cli.generate(model, torch.from_numpy(tokens).long(), new,
                             timings=times)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, new)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(times) == {"prefill_s", "decode_s"}


# ------------------------------------------------- (e) the train CLI
def test_train_losses_equal_the_reference_cli_loop():
    rmodel, rparams = _ref_model()
    ropt = ref_make_optimizer(RefOptCfg())
    step_fn = jax.jit(ref_make_train_step(rmodel, ropt))
    rdata = RefSyntheticLM(RefDataCfg(vocab=rmodel.cfg.vocab,
                                      seq=TRAIN["seq"],
                                      global_batch=TRAIN["global_batch"]))
    p, st = rparams, ropt.init(rparams)
    want = []
    for i in range(TRAIN["steps"]):
        b = {k: jnp.asarray(v) for k, v in rdata.batch(i).items()}
        p, st, m = step_fn(p, st, b, jnp.asarray(i))
        want.append(float(m["loss"]))

    model = _port_model(rparams)
    data = SyntheticLM(DataCfg(vocab=model.cfg.vocab, seq=TRAIN["seq"],
                               global_batch=TRAIN["global_batch"]))
    seen = []
    got = train_cli.train(model, make_optimizer(OptCfg()), data,
                          TRAIN["steps"],
                          on_step=lambda i, loss, dt: seen.append((i, loss)))
    assert seen == list(enumerate(got))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    # the trained parameters are installed in the model
    np.testing.assert_allclose(
        model.params["embed"].detach().numpy(), np.asarray(p["embed"]),
        rtol=1e-5, atol=1e-6)


# ------------------------------------------------- (f) both CLIs' main
@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-370m",
                                  "whisper-tiny"])
def test_cli_mains_run_on_the_cpu(arch, capsys):
    assert serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8",
                           "--max-new", "4"]) == 0
    assert train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--steps", "2", "--batch", "2",
                           "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert f"{arch}: prefill(2x8)" in out and "decode 6 tokens" in out
    assert "params on cpu" in out
    assert "step 0: loss=" in out and "step 1: loss=" in out


def test_cli_mains_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for main, extra in ((serve_cli.main, []),
                        (train_cli.main, ["--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--arch", ARCH, "--reduced"] + extra)


# ---------------------------------------- (g) --distributed-init (gloo)
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_train_cli_distributed_init_gloo(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), RANK="0", WORLD_SIZE="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--steps", "1", "--batch", "2",
         "--seq", "16", "--distributed-init"],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "rank 0 of 1" in proc.stdout
    assert "step 0: loss=" in proc.stdout


# ------------------------------------------------------ (h) the dry-run
def test_dryrun_main_writes_its_json(tmp_path, capsys):
    assert dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                        "--outdir", str(tmp_path)]) == 0
    res = json.loads((tmp_path / "whisper-tiny__decode_32k.json").read_text())
    assert res["ok"] and res["mesh"] == "16x16" and res["n_devices"] == 256
    assert res["meta"]["attn_impl"] == "ref"
    assert res["params"]["ok"] and res["params"]["rel_err"] < 0.08
    assert res["memory"]["argument_size_in_bytes"] > 0
    assert res["analysis"]["flops"] > 0
    assert "1 cells" in capsys.readouterr().out


def test_train_cli_dry_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert train_cli.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                           "--dry-run", "--multi-pod"]) == 0
    path = (tmp_path / "experiments" / "dryrun_torch" / "pod2x16x16"
            / "mamba2-370m__decode_32k.json")
    res = json.loads(path.read_text())
    assert res["ok"] and res["mesh"] == "2x16x16"


def test_dryrun_records_the_ports_refusal(tmp_path):
    """A 32,768-token prefill does not fit gemma3-1b's window caches of
    512: the port's prefill refuses it, and the cell records that."""
    res = dryrun.run_cell("gemma3-1b", "prefill_32k", False, str(tmp_path),
                          verbose=False)
    assert not res["ok"] and "do not fit" in res["error"]
    assert json.loads((tmp_path / "gemma3-1b__prefill_32k.json"
                       ).read_text())["error"] == res["error"]
