"""The port's LM over a mesh: 8 gloo CPU ranks against the port on one device
and the JAX package's single-device reference.

One module fixture writes the inputs (numpy seeds) and the reference's
parameters (``repro.models.init_params``, handed over as numpy through
``convert.lm_params_from_reference``), then launches eight ``python -c``
ranks of the port (no JAX) over a ``file://`` rendezvous under ``tmp_path``,
each under a time limit and a collective timeout.  Every rank runs every
case and writes its results; the tests read them:

* (a) ``tests/test_distributed.py:76`` mirrored: reduced yi-9b on ``(4, 2)``
  ``tp_sp``: the sharded step's loss is within the reference's own 5e-3 of
  the reference's single-device loss, and within :data:`LOSS_ATOL` of the
  port's unsharded step; the gradient norm and the parameters after the step
  are within :data:`GNORM_RTOL` and :data:`PARAM_ATOL` of it; every rank's
  local shapes are the ones its spec gives;
* (b) ``:121`` mirrored: reduced qwen1.5-4b ``fsdp`` on ``(8,)``: finite,
  ``shape[0] == 8``, and equal to the unsharded forward within
  :data:`LOGIT_ATOL`;
* (c) reduced zamba2-7b and reduced qwen3-moe through
  ``ServeEngine(rules=...)`` on ``(4, 2)``: tokens equal the unsharded
  run's, prefill and decode logits within :data:`LOGIT_ATOL`;
* (d) ``restore(shardings=)``: the state saved on ``(4, 2)`` ``tp_sp``
  restored on ``(8,)`` ``fsdp`` on every rank, and in a world of one in
  this process: the arrays are equal;
* (e) reduced yi-9b on ``(2, 4)``: 4 query heads split over ``model`` = 4,
  2 KV heads do not, so each rank expands its KV heads: the forward equals
  the unsharded one within :data:`LOGIT_ATOL`;
* (f) the other paths under ``rules`` on ``(4, 2)``, prefill and a decode
  step against the unsharded model: gemma3 (ring caches of its windowed
  layers), whisper-tiny (the encoder and the cross K/V in the cache) and
  phi-3-vision (the patch splice);
* (g) reduced qwen3-moe on ``(1, 8)``: its 4 experts do not divide
  ``model`` = 8, so the expert FFN dim is split instead: the forward equals
  the unsharded one.
"""
import json
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch.steps import TrainState as JTrainState
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import init_params as jinit_params
from repro.optim import adamw_init as jadamw_init

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLD = 8
RANK_TIMEOUT_S = 240  # a hung collective fails the launch, not the suite
ARCHS = ("yi-9b", "qwen1.5-4b", "zamba2-7b", "qwen3-moe-235b-a22b", "gemma3-12b",
         "whisper-tiny", "phi-3-vision-4.2b")
FAMILIES = ("gemma3-12b", "whisper-tiny", "phi-3-vision-4.2b")
REF_LOSS_ATOL = 5e-3  # the reference's own bound (tests/test_distributed.py)
LOSS_ATOL = 1e-5  # sharded vs the port's unsharded step: f32, sums in another order
GNORM_RTOL = 1e-5
# AdamW's first step is lr·sign(g) where |g| >> eps; an element whose gradient is
# near eps moves by up to lr under a gradient change of a few ulps
PEAK_LR = 3e-4
PARAM_ATOL = 0.1 * PEAK_LR
LOGIT_ATOL = 2e-5

RANK_CODE = r"""
import datetime, json, pickle, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, init, io = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.checkpoint.manager import CheckpointManager, flatten_state
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.distributed import sharding as S
from repro_torch.launch import steps as ST
from repro_torch.models import decode as D
from repro_torch.serving.engine import ServeEngine

inputs = dict(np.load(f"{io}/inputs.npz"))
params = pickle.load(open(f"{io}/params.pkl", "rb"))
mesh42 = DeviceMesh("cpu", torch.arange(world).reshape(4, 2), mesh_dim_names=("data", "model"))
mesh24 = DeviceMesh("cpu", torch.arange(world).reshape(2, 4), mesh_dim_names=("data", "model"))
mesh8 = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("data",))
mesh18 = DeviceMesh("cpu", torch.arange(world).reshape(1, 8), mesh_dim_names=("data", "model"))
out = {}

def model_of(arch):
    return lm_params_from_reference(params[arch], reduced(get_config(arch)), device="cpu")

def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t

# (a) yi-9b, (4, 2) tp_sp: one train step, sharded and not
cfg = reduced(get_config("yi-9b"))
toks = torch.from_numpy(inputs["yi_toks"]).long()
batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
step_kw = dict(peak_lr=float(inputs["peak_lr"]), warmup=0)
plain = model_of("yi-9b")
st0, m0 = ST.make_train_step(cfg, **step_kw)(ST.make_train_state(plain), batch)
model = model_of("yi-9b")
specs = S.param_specs(model, mesh42)
S.distribute_params(model, mesh42, specs)
rules = S.make_rules(mesh42)
st1, m1 = ST.make_train_step(cfg, rules=rules, **step_kw)(ST.make_train_state(model), batch)
out["a"] = {"loss": float(m1["loss"]), "loss_plain": float(m0["loss"]),
            "gnorm": float(m1["grad_norm"]), "gnorm_plain": float(m0["grad_norm"]),
            "param_diff": max(float((full(p).detach() - q.detach()).abs().max())
                              for (_, p), (_, q) in zip(model.named_parameters(),
                                                        plain.named_parameters())),
            "moment_diff": max(float((full(st1.opt.m[n]) - st0.opt.m[n]).abs().max())
                               for n in st0.opt.m),
            "local_shapes": {n: list(p.to_local().shape) for n, p in model.named_parameters()},
            "moment_shapes": {n: list(st1.opt.v[n].to_local().shape) for n in st0.opt.v},
            "coord": mesh42.get_coordinate()}

# (d) save the sharded state on (4, 2), restore on (8,) fsdp
mgr = CheckpointManager(f"{io}/ckpt")
mgr.save(1, st1)
fresh = ST.make_train_state(model_of("yi-9b"))
ps8, opt8 = S.train_state_specs(fresh.model, mesh8, "fsdp")
sh = ST.TrainState(S.named(mesh8, ps8), S.named(mesh8, opt8), S.NamedSharding(mesh8, ()))
back, step = mgr.restore(fresh, shardings=sh)
saved = flatten_state(st1)
got = flatten_state(back)
out["d"] = {"step": step, "equal": all(torch.equal(full(saved[k]).detach().cpu(),
                                                   full(got[k]).detach().cpu()) for k in saved),
            "fsdp_placements": str(back.model.embed.placements),
            "local": list(back.model.embed.to_local().shape)}

# (b) qwen1.5-4b fsdp on (8,): the forward
cfg = reduced(get_config("qwen1.5-4b"))
qt = torch.from_numpy(inputs["qwen_toks"]).long()
with torch.no_grad():
    ref_logits = model_of("qwen1.5-4b")(qt, impl="plain")
    model = model_of("qwen1.5-4b")
    S.distribute_params(model, mesh8, S.param_specs(model, mesh8, "fsdp"))
    lg = model(qt, impl="plain", rules=S.make_rules(mesh8, "fsdp")).full_tensor()
out["b"] = {"shape": list(lg.shape), "finite": bool(torch.isfinite(lg).all()),
            "diff": float((lg - ref_logits).abs().max())}

# (e) yi-9b on (2, 4): kv heads expanded to each rank's query heads
cfg = reduced(get_config("yi-9b"))
with torch.no_grad():
    ref_logits = model_of("yi-9b")(batch["tokens"], impl="plain")
    model = model_of("yi-9b")
    S.distribute_params(model, mesh24, S.param_specs(model, mesh24))
    lg = model(batch["tokens"], impl="plain", rules=S.make_rules(mesh24)).full_tensor()
out["e"] = {"diff": float((lg - ref_logits).abs().max())}

# (g) qwen3-moe on (1, 8): TP on the expert FFN dim
cfg = reduced(get_config("qwen3-moe-235b-a22b"))
with torch.no_grad():
    ref_logits = model_of("qwen3-moe-235b-a22b")(qt, impl="plain")
    model = model_of("qwen3-moe-235b-a22b")
    S.distribute_params(model, mesh18, S.param_specs(model, mesh18))
    lg = model(qt, impl="plain", rules=S.make_rules(mesh18)).full_tensor()
out["g"] = {"diff": float((lg - ref_logits).abs().max()),
            "w_gate": str(model.layers[0].moe.w_gate.placements)}

# (f) gemma3, whisper, phi-3-vision: prefill and decode under rules on (4, 2)
for arch in ("gemma3-12b", "whisper-tiny", "phi-3-vision-4.2b"):
    cfg = reduced(get_config(arch))
    ftoks = torch.from_numpy(inputs["family_toks"]).long()
    kw = {}
    if cfg.family == "encdec":
        kw["enc_frames"] = torch.from_numpy(inputs["frames"][:, :cfg.enc_seq])
    if cfg.family == "vlm":
        kw["patch_embeds"] = torch.from_numpy(inputs["patches"][:, :cfg.num_patches])
    res = []
    for sharded in (False, True):
        model = model_of(arch)
        rules = None
        if sharded:
            S.distribute_params(model, mesh42, S.param_specs(model, mesh42))
            rules = S.make_rules(mesh42)
        with torch.no_grad():
            l0, cache = D.prefill(model, ftoks, impl="plain", max_seq=24, rules=rules, **kw)
            l1, cache = D.decode_step(model, cache, ftoks[:, -1], ftoks.shape[1], rules=rules)
            l2, _ = D.decode_step(model, cache, ftoks[:, -2], ftoks.shape[1] + 1, rules=rules)
        res.append([full(t) for t in (l0, l1, l2)])
    out["f_" + arch] = {"diff": max(float((a - b).abs().max()) for a, b in zip(*res))}

# (c) ServeEngine(rules=) on (4, 2)
for arch in ("zamba2-7b", "qwen3-moe-235b-a22b"):
    cfg = reduced(get_config(arch))
    prompts = [inputs[f"prompt{i}"] for i in range(6)]
    res = {}
    for name, sharded in (("plain", False), ("sharded", True)):
        model = model_of(arch)
        rules = None
        if sharded:
            S.distribute_params(model, mesh42, S.param_specs(model, mesh42))
            rules = S.make_rules(mesh42)
        eng = ServeEngine(cfg, model, max_slots=4, max_seq=24, impl="plain", device="cpu",
                          rules=rules)
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_until_drained()
        ptoks = torch.from_numpy(np.stack([p[:5] for p in prompts[:4]])).long()
        with torch.no_grad():
            l0, cache = D.prefill(model, ptoks, impl="plain", max_seq=8, rules=rules)
            l1, _ = D.decode_step(model, cache, ptoks[:, 0], 5, rules=rules)
        res[name] = ([r.out_tokens for r in reqs], full(l0), full(l1),
                     [str(v.placements) for v in cache[0].values()] if sharded else None)
    out["c_" + arch] = {"tokens_equal": res["plain"][0] == res["sharded"][0],
                        "tokens": res["plain"][0],
                        "prefill_diff": float((res["plain"][1] - res["sharded"][1]).abs().max()),
                        "decode_diff": float((res["plain"][2] - res["sharded"][2]).abs().max()),
                        "cache_placements": res["sharded"][3]}

with open(f"{io}/rank{rank}.json", "w") as f:
    json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def _launch(tmp: pathlib.Path) -> list[dict]:
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    env.pop("JAX_PLATFORMS", None)
    init = f"file://{tmp}/rendezvous"
    procs = [subprocess.Popen([sys.executable, "-c", RANK_CODE, str(r), str(WORLD), init, str(tmp)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(WORLD)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs and reference parameters written, the reference's loss taken,
    the eight ranks run: ``(ranks, reference loss, tmp dir)``."""
    tmp = tmp_path_factory.mktemp("distributed")
    rng = np.random.default_rng(1)
    inputs = {"yi_toks": rng.integers(0, 512, (8, 33)).astype(np.int32),
              "qwen_toks": rng.integers(0, 512, (8, 16)).astype(np.int32),
              "peak_lr": np.float32(PEAK_LR)}
    inputs["family_toks"] = rng.integers(1, 512, (4, 20)).astype(np.int32)
    inputs["frames"] = (rng.standard_normal((4, 32, 64)) * 0.02).astype(np.float32)
    inputs["patches"] = (rng.standard_normal((4, 8, 64)) * 0.02).astype(np.float32)
    for i, n in enumerate((5, 9, 7, 12, 3, 8)):
        inputs[f"prompt{i}"] = rng.integers(1, 512, n).astype(np.int32)
    np.savez(tmp / "inputs.npz", **inputs)
    params = {a: jax.tree.map(np.asarray, jinit_params(jreduced(jget_config(a)),
                                                       jax.random.PRNGKey(0)))
              for a in ARCHS}
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(params, f)
    # the reference's single-device loss (tests/test_distributed.py's ref_step)
    cfg = jreduced(jget_config("yi-9b"))
    p = jax.tree.map(jnp.asarray, params["yi-9b"])
    toks = jnp.asarray(inputs["yi_toks"])
    st0 = JTrainState(p, jadamw_init(p), jnp.zeros((), jnp.int32))
    _, m = jax.jit(jmake_train_step(cfg, rules=None))(
        st0, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return _launch(tmp), float(m["loss"]), tmp


def test_sharded_train_step_matches_reference_and_unsharded_loss(run):
    ranks, ref_loss, _ = run
    for r in ranks:
        a = r["a"]
        assert abs(a["loss"] - ref_loss) < REF_LOSS_ATOL, (a, ref_loss)
        assert abs(a["loss"] - a["loss_plain"]) < LOSS_ATOL, a
        assert abs(a["gnorm"] - a["gnorm_plain"]) <= GNORM_RTOL * a["gnorm_plain"], a
        assert 0 < a["param_diff"] <= PARAM_ATOL and a["moment_diff"] <= 1e-6, a
    assert len({r["a"]["loss"] for r in ranks}) == 1  # one loss on every rank


def test_every_rank_holds_the_shards_its_specs_give(run):
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.specs import abstract_model

    model = abstract_model(reduced(get_config("yi-9b")), torch.float32)
    mesh = S.MeshShape(("data", "model"), (4, 2))
    specs = S.param_specs(model, mesh)
    sizes = S.mesh_sizes(mesh)
    for r in run[0]:
        coord = dict(zip(("data", "model"), r["a"]["coord"]))
        for name, p in model.named_parameters():
            want = list(p.shape)
            for d, entry in enumerate(specs[name]):
                for axis in (() if entry is None else (entry,) if isinstance(entry, str)
                             else entry):
                    n, c = want[d], coord[axis]
                    w = -(-n // sizes[axis])  # torch.chunk's rule
                    want[d] = max(0, min(w, n - c * w))
            assert r["a"]["local_shapes"][name] == want, (name, coord)
            assert r["a"]["moment_shapes"][name] == want, name


def test_fsdp_layout_forward_equals_unsharded(run):
    for r in run[0]:
        b = r["b"]
        assert b["finite"] and b["shape"][0] == 8 and b["diff"] <= LOGIT_ATOL, b


def test_split_query_heads_expand_the_kv_heads_exactly_enough(run):
    for r in run[0]:
        assert r["e"]["diff"] <= LOGIT_ATOL, r["e"]


def test_moe_splits_the_expert_ffn_where_the_experts_do_not_divide(run):
    for r in run[0]:
        assert r["g"]["diff"] <= LOGIT_ATOL, r["g"]
        assert r["g"]["w_gate"] == "(Shard(dim=1), Shard(dim=2))", r["g"]  # (None, dp, tp)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_under_rules_equal_unsharded(run, arch):
    for r in run[0]:
        assert r["f_" + arch]["diff"] <= LOGIT_ATOL, r["f_" + arch]


@pytest.mark.parametrize("arch", ["zamba2-7b", "qwen3-moe-235b-a22b"])
def test_serve_engine_with_rules_equals_unsharded(run, arch):
    for r in run[0]:
        c = r["c_" + arch]
        assert c["tokens_equal"], c
        assert c["prefill_diff"] <= LOGIT_ATOL and c["decode_diff"] <= LOGIT_ATOL, c
        assert all("Shard(dim=0)" in p for p in c["cache_placements"]), c


def test_restore_on_another_mesh_and_in_a_world_of_one(run):
    from repro_torch.checkpoint.manager import CheckpointManager, flatten_state
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import steps as ST
    from repro_torch.models.lm import init_params

    ranks, _, tmp = run
    for r in ranks:
        d = r["d"]
        assert d["step"] == 1 and d["equal"], d
        assert d["fsdp_placements"] == "(Shard(dim=0),)" and d["local"] == [64, 64], d
    # a world of one: the same arrays restored with no mesh at all
    mgr = CheckpointManager(tmp / "ckpt")
    state = ST.make_train_state(init_params(reduced(get_config("yi-9b")), 0, "cpu"))
    back, step = mgr.restore(state)
    got = flatten_state(back)
    meta = json.loads((tmp / "ckpt" / "step_1" / "meta.json").read_text())
    assert step == 1 and set(meta["manifest"]) == set(got)
    for k, info in meta["manifest"].items():
        arr = np.load(tmp / "ckpt" / "step_1" / info["file"])
        assert np.array_equal(got[k].detach().numpy(), arr), k
