"""The port's multi-device layer on the CPU over gloo: the mesh and its
collectives, ``param_shardings``, the sharded train step against the
unsharded one and against the JAX package's, the engine over a mesh,
``host_local_batch`` and the dryrun, ``fit`` over a mesh, and the CLI's
``--data_parallel``.  Each world shape (2 ranks on ``("data",)``, 4 on
``("data", "model")`` (2, 2)) is spawned once for the module, runs every
scenario of ``tests/_torch_mesh_worlds.py`` and returns its results; the
tests below hold them.  At the JAX tests' ``TINY`` spec."""

import json
import os

import numpy as np
import pytest
import torch

import wadt  # noqa: F401
from tests import _torch_mesh_worlds as W
from tools.make_synth_dataset import make as make_synth

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch import (
    cli,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine import (
    checkpoint as tck,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.engine.executor import (
    Engine,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel import (
    dryrun,
    mesh as tmesh,
    train as ttrain,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.parallel.multihost import (
    host_local_batch,
    spawn_world,
)
from _torch_threads import one_torch_thread  # noqa: F401

LR = 3e-4
WORLD_TIMEOUT_S = 240.0


def _jax_states():
    """The JAX package's state before each of 3 float32 steps (dropout 0)
    from the port's seeded init, as the port's numpy trees, and its losses."""
    import jax.numpy as jnp

    from wadt.models import pmg as jpmg
    from wadt.parallel import train as jtrain

    spec, params = W.spec_params()
    jopt = jtrain.make_optimizer()
    jparams = ttrain._map_tree(lambda _, t: jnp.asarray(t.numpy()), params)
    jstate = jtrain.TrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    _, jstep = jtrain.make_train_step("pmg", jpmg.build_spec(W.TASKS, W.TINY), jopt,
                                      dropout_rate=0.0)
    states, losses = [], []
    for i in range(W.STEPS + 1):
        states.append(W.state_np(tck.train_state_from_jax(jstate, spec)))
        if i < W.STEPS:
            jstate, jloss = jstep(jstate, *W.batch(20 + i))
            losses.append(float(jloss))
    return states, losses


@pytest.fixture(scope="module")
def jax_ref():
    return _jax_states()


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    return make_synth(str(tmp_path_factory.mktemp("mesh") / "synth"), n_per_class=3, size=64)


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded run of every train case: (losses, states)."""
    return {c: W.run_case(c) for c in W.TRAIN_CASES}


@pytest.fixture(scope="module")
def worlds(jax_ref, synth_root, unsharded):
    """Each world shape run once: its ranks' results by mesh name."""
    jax_states = jax_ref[0][:W.STEPS]
    ref_states = {c: states[:W.STEPS] for c, (_, states) in unsharded.items()}
    return {
        "data2": spawn_world(W._world, 2, "data2", synth_root, jax_states, ref_states,
                             timeout_s=WORLD_TIMEOUT_S),
        "mesh22": spawn_world(W._world, 4, "mesh22", None, jax_states, ref_states,
                              timeout_s=WORLD_TIMEOUT_S),
    }


def _hold_params(got, want, grads, frac, steps, what, noise=1e-4):
    """Every leaf within ``frac`` x its max.  Where a step's gradient is at
    rounding noise (at most ``noise`` x that step's largest; 1e-4 is
    test_torch_train.py's float32 bar), Adam's per-element normalization moves the element
    by up to lr a step in either run, so those elements are held to 2 x lr
    a step.  bf16 passes ``noise=1``: its rounding reaches every small
    gradient, so every element is held to the larger of the two."""
    got, want = ttrain.leaf_dict(got), ttrain.leaf_dict(want)
    assert set(got) == set(want), what
    for p, w in want.items():
        g = got[p]
        assert g.shape == w.shape, (what, p)
        noisy = np.zeros(w.shape, bool)
        for step_grads in grads:
            if p in step_grads:
                top = max(float(np.abs(v).max()) for v in step_grads.values())
                noisy |= np.abs(step_grads[p]) <= noise * top
        err = np.abs(g - w)
        tol = frac * max(float(np.abs(w).max()), 1e-12)
        assert err[~noisy].max(initial=0.0) <= tol, (what, p, float(err[~noisy].max()), tol)
        assert err[noisy].max(initial=0.0) <= max(tol, 2 * LR * steps), (what, p)


def _hold_moments(got, want, frac, what, floor_frac=None, grads=(), noise=1e-4):
    """test_torch_train.py's bar for AdamW's moments, statistics of the
    gradients: the
    first within ``frac`` (1e-4 in float32) x its leaf's max, the second, a
    square, within twice that; a leaf of gradient noise to 1e-6 x the
    largest moment (1e-12 for the second).  bf16 gradients agree to bf16's
    precision of the largest terms they sum, not element by element, so
    bf16 passes ``floor_frac``: each moment within that x the largest.

    ``grads`` (the reference run's, as _hold_params takes them) names the
    leaves whose gradient is rounding noise, every element at most
    ``noise`` x its step's largest (_hold_params's bar): a convolution's
    bias that an instance norm cancels has a zero gradient in exact
    arithmetic, so its moments are float32 residue that two runs need not
    share.  Such a leaf is held to the noise level on both sides, the
    first moment within ``noise`` x the largest gradient and the second
    within its square, and not one run's residue to the other's."""
    tops = [max(float(np.abs(v).max()) for v in g.values()) for g in grads]
    bar = noise * max(tops, default=0.0)
    noisy = {p for p in want["opt"]["exp_avg"]
             if grads and all(p in g and float(np.abs(g[p]).max()) <= noise * t
                              for g, t in zip(grads, tops))}
    for part, k in (("exp_avg", 1.0), ("exp_avg_sq", 2.0)):
        top = max(float(np.abs(v).max()) for v in want["opt"][part].values())
        floor = (floor_frac or (1e-12 if part == "exp_avg_sq" else 1e-6)) * top
        for p, w in want["opt"][part].items():
            if p in noisy:
                for side, v in (("got", got["opt"][part][p]), ("want", w)):
                    assert float(np.abs(v).max()) <= bar ** k, (what, part, p, side)
                continue
            tol = max(k * frac * float(np.abs(w).max()), floor)
            np.testing.assert_allclose(got["opt"][part][p], w, atol=tol, rtol=0,
                                       err_msg=f"{what} {part} {p}")


# ---------------------------------------------------------------------------
# the mesh in one process, and its layouts
# ---------------------------------------------------------------------------


def test_make_mesh_world_of_one():
    """Without a process group make_mesh() is a mesh of one rank: every
    collective is the identity and every row and task belongs to it."""
    m = tmesh.make_mesh()
    assert (m.size, m.rank, m.shape, m.is_main) == (1, 0, (1,), True)
    t = torch.arange(6.0).reshape(2, 3)
    assert m.all_reduce(t) is t and m.gather(t, "data") is t
    assert m.row_range(7) == (0, 7)
    m2 = tmesh.make_mesh(1, axes=("data", "model"), shape=(1, 1))
    assert m2.coords == {"data": 0, "model": 0} and ttrain.task_range(m2, 5) == (0, 5)
    with pytest.raises(ValueError, match="the world has 1"):
        tmesh.make_mesh(2)
    with pytest.raises(ValueError, match="needs 4 processes"):
        tmesh.make_mesh(axes=("data", "model"), shape=(2, 2))
    assert tmesh.pad_to_multiple(37, 16) == 48 and tmesh.pad_to_multiple(32, 16) == 32
    rows, lo, total = tmesh.batch_rows(m, np.zeros((5, 2)))
    assert (rows.shape, lo, total) == ((5, 2), 0, 5)
    (hl,) = host_local_batch(m, np.zeros((3, 2)))
    assert (hl.lo, hl.total) == (0, 3) and tmesh.batch_rows(m, hl)[1:] == (0, 3)


def test_param_shardings_path_aware():
    """Only root-level task-stacked subtrees shard over 'model', as in the
    JAX package, leaf for leaf: PMG's transformer attn and ffn replicate."""
    from jax.sharding import PartitionSpec as P

    from wadt.parallel.mesh import make_mesh as jmake_mesh
    from wadt.parallel.train import param_shardings as jshardings

    spec, params = W.spec_params()
    sh = ttrain.param_shardings(params, tmesh.make_mesh(1, axes=("data", "model"), shape=(1, 1)))
    assert sh["heads"]["w"] == ("model", None, None) and sh["queries"] == ("model", None)
    for leaf in (*sh["transformer"][0]["attn"].values(), *sh["transformer"][0]["ffn1"].values()):
        assert leaf == ()
    jsh = jshardings(ttrain._map_tree(lambda _, t: np.asarray(t), params),
                     jmake_mesh(8, axes=("data", "model"), shape=(4, 2)))
    import jax

    got = {}
    for path, _ in ttrain._named_leaves(params):
        node = sh
        for k in path:
            node = node[k]
        got["/".join(map(str, path))] = node

    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_flatten_with_path(jsh)[0]}
    assert set(got) == set(want)
    assert all(tuple(got[p]) == tuple(P(*want[p])) for p in want), (got, want)
    assert ttrain.param_shardings(params, tmesh.make_mesh())["heads"]["w"] == ()


def test_uneven_task_split_raises_as_in_jax(worlds):
    """3 tasks over a 'model' axis of 2: both packages raise ValueError."""
    import jax

    from wadt.models import pmg as jpmg
    from wadt.parallel.mesh import make_mesh as jmake_mesh
    from wadt.parallel.train import make_train_step as jstep

    for r in worlds["mesh22"]:
        assert r["uneven"] and "do not split evenly" in r["uneven"]
    spec = jpmg.build_spec({**W.TASKS, "C": ["c0", "c1"]}, W.TINY)
    with pytest.raises(ValueError):
        init_fn, _ = jstep("pmg", spec, mesh=jmake_mesh(8, axes=("data", "model"), shape=(4, 2)))
        init_fn(jax.random.PRNGKey(0))


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(W.MESHES))
@pytest.mark.parametrize("case", list(W.TRAIN_CASES))
def test_sharded_steps_match_unsharded(worlds, unsharded, name, case):
    """3 sharded steps equal 3 unsharded ones (labels[0, 0] missing, so the
    missing labels fall on one data rank), each from the unsharded run's
    state of the moment (as test_torch_train.py holds the port to JAX, so
    that rounding
    differences do not compound through Adam): every rank's loss within
    1e-5 relative, the gathered params, running statistics and moments
    within 1e-5 x their leaf's max (see _hold_params); bf16 within PERF.md
    section 2's 1e-2; the moments as _hold_moments says.  Running
    free from the same init, the 3 losses agree to the same bar."""
    frac = 1e-2 if case == "bf16" else 1e-5
    want_losses, states = unsharded[case]
    for r in worlds[name]:
        what = f"{name} {case} rank {r['rank']}"
        np.testing.assert_allclose(r["free"][case], want_losses, rtol=frac, err_msg=what)
        for i, (loss, got) in enumerate(r["train"][case]):
            want = states[i + 1]
            np.testing.assert_allclose(loss, want_losses[i], rtol=frac, err_msg=what)
            assert got["step"] == want["step"] == i + 1
            _hold_params(got["params"], want["params"], [want["grads"]], frac, 1,
                         f"{what} step {i}", noise=1.0 if case == "bf16" else 1e-4)
            _hold_moments(got, want, max(frac, 1e-4), f"{what} step {i}",
                          floor_frac=2e-2 if case == "bf16" else None,
                          grads=() if case == "bf16" else [want["grads"]])


@pytest.mark.parametrize("name", list(W.MESHES))
def test_sharded_loss_decreases_and_tasks_are_sliced(worlds, name):
    """8 steps on one batch: the loss falls on every rank alike; on a
    'model' axis of 2 each rank holds one task's slice of the task-stacked
    params and of their moments, and a full copy of everything else."""
    world = worlds[name]
    spec, params = W.spec_params()
    full = {p: tuple(t.shape) for p, t in ttrain.leaf_dict(params).items()}
    for r in world:
        d = r["decrease"]
        assert d["losses"][-1] < d["losses"][0], d["losses"]
        assert d["losses"] == world[0]["decrease"]["losses"] and d["step"] == 8
        m = 2 if name == "mesh22" else 1
        for p, shape in full.items():
            root = p.split("/")[0]
            want = ((shape[0] // m,) + shape[1:]) if root in ("queries", "heads") else shape
            assert d["local_shapes"][p] == want, (p, d["local_shapes"][p])
            if p in d["moment_shapes"]:
                assert d["moment_shapes"][p] == want
    if name == "mesh22":
        assert sorted(tuple(r["coords"].values()) for r in world) == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("name", list(W.MESHES))
def test_sharded_bf16_master_params_stay_float32(worlds, name):
    for r in worlds[name]:
        assert r["bf16_dtypes"] == ["torch.float32"]


@pytest.mark.parametrize("name", list(W.MESHES))
def test_sharded_steps_match_jax(worlds, jax_ref, name):
    """One sharded step from each of the JAX package's states (carried
    across by train_state_from_jax) within test_torch_train.py's tolerances of
    the JAX step: loss 1e-5 relative, moments 1e-4 x their leaf's max,
    running statistics 1e-5, params 1e-5 (2 x lr where the gradient is
    float32 noise)."""
    states, jlosses = jax_ref
    for r in worlds[name]:
        for i, (loss, got) in enumerate(r["jax"]):
            want = states[i + 1]
            np.testing.assert_allclose(loss, jlosses[i], rtol=1e-5)
            assert got["step"] == want["step"] == i + 1
            _hold_moments(got, want, 1e-4, f"{name} step {i}")
            top = max(float(np.abs(g).max()) for g in got["grads"].values())
            params_now = ttrain.leaf_dict(got["params"])
            for p, w in ttrain.leaf_dict(want["params"]).items():
                err = np.abs(params_now[p] - w)
                if p.endswith(("/mean", "/var")):
                    np.testing.assert_allclose(params_now[p], w, atol=1e-5, rtol=1e-5)
                    continue
                noisy = np.abs(got["grads"][p]) <= 1e-4 * top
                assert err[~noisy].max(initial=0.0) <= 1e-5, (name, i, p)
                assert err[noisy].max(initial=0.0) <= 2 * LR, (name, i, p)


@pytest.mark.parametrize("name", list(W.MESHES))
def test_host_local_batch_equals_global_batch(worlds, name):
    """The step takes this rank's rows marked by host_local_batch as it
    takes the global batch: the same loss and params bit for bit."""
    for r in worlds[name]:
        la, lb, same = r["host_local"]
        assert la == lb and same


def test_host_local_batch_dryrun():
    """The dryrun (2 processes over gloo, each feeding its half of the
    batch through host_local_batch): losses within 1e-5 of one process."""
    res = dryrun.run("cpu")
    assert res["max_diff"] < dryrun.TOL and len(res["multi"]) == dryrun.STEPS


def test_dryrun_needs_a_card_by_default(monkeypatch):
    """The dryrun runs on the card unless asked for the CPU: without one,
    run() and the command line raise with the --device cpu hint before any
    process starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dryrun, "_child", None)  # a spawned world would fail on it
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main([])


# ---------------------------------------------------------------------------
# the engine over a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("how", ["per_batch", "scan_chunk", "run_stream"])
def test_engine_mesh_matches_single(worlds, how):
    """A 2-rank ('data',) engine gives every rank the single-process
    engine's results within 1e-5: per batch (37 frames: a padded tail, with
    labels: the loss per task and counts too), with scan_chunk=2, and
    through run_stream."""
    spec, params = W.spec_params()
    single = Engine("pmg", spec, params, batch_size=16, device="cpu")
    imgs = np.random.RandomState(1).randint(0, 256, (37, 32, 32, 3), np.uint8)
    for r in worlds["data2"]:
        got = r["engine"][how]
        if how == "per_batch":
            want = single.run(imgs, W.batch(6, 37)[1], collect=("logits", "preds"))
            np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-5, rtol=1e-5)
            np.testing.assert_array_equal(got["preds"], want["preds"])
            np.testing.assert_array_equal(got["count_per_task"], want["count_per_task"])
            np.testing.assert_allclose(got["loss_per_task"], want["loss_per_task"], rtol=1e-5)
        else:
            want = single.run(imgs[:32] if how == "scan_chunk" else imgs,
                              collect=("logits",))["logits"]
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_engine_mesh_guards():
    spec, params = W.spec_params()
    with pytest.raises(TypeError, match="make_mesh"):
        Engine("pmg", spec, params, mesh=object(), device="cpu")
    eng = Engine("pmg", spec, params, batch_size=3, mesh=tmesh.make_mesh(), device="cpu")
    assert eng.mesh is not None and eng._rows == slice(0, 3)


# ---------------------------------------------------------------------------
# fit over a mesh, and the CLI
# ---------------------------------------------------------------------------


def test_fit_mesh_resumes_exactly(worlds):
    """fit over the 2-rank mesh (dropout and augmentation on): 1 epoch and a
    resume to 3 equal a straight 3-epoch run (losses rtol 1e-5, params
    within 1e-6), every rank returning the same history and best F1, and
    rank 0 writing the JAX package's artifacts."""
    world = worlds["data2"]
    for r in world:
        a, b = r["fit"]["straight"], r["fit"]["resumed"]
        assert [h[0] for h in b["history"]] == [0, 1, 2]
        np.testing.assert_allclose([h[1] for h in a["history"]], [h[1] for h in b["history"]],
                                   rtol=1e-5)
        pa, pb = ttrain.leaf_dict(a["params"]), ttrain.leaf_dict(b["params"])
        for k in pa:
            np.testing.assert_allclose(pa[k], pb[k], atol=1e-6)
        assert r["fit"]["resumed"]["history"] == world[0]["fit"]["resumed"]["history"]
        assert r["fit"]["resumed"]["best_f1"] == world[0]["fit"]["resumed"]["best_f1"]
    assert {"best_model", "best_model.pth", "hyperparameters.json", "training_history.json",
            "last_state", "train_progress.json"} <= set(world[0]["fit_files"])


def test_cli_data_parallel_world_of_one_runs_unsharded(synth_root, tmp_path, monkeypatch, capsys):
    """--data_parallel with WORLD_SIZE=1 in the environment: one process,
    unsharded, as the JAX CLI on one device."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    hp = tmp_path / "hp.json"
    hp.write_text(json.dumps({"hparams": W.TINY}))
    rc = cli.main(["pmg", "--mode", "inference", "--image_folder",
                   os.path.join(synth_root, "images"), "--build_classifier",
                   os.path.join(synth_root, "tasks.json"), "--config_path", str(hp),
                   "--batch_size", "4", "--save_dir", str(tmp_path / "out"), "--device", "cpu",
                   "--data_parallel"])
    assert rc == 0
    assert "single device visible; running unsharded" in capsys.readouterr().out


def test_cli_data_parallel_rank_zero_writes_once(worlds, synth_root, tmp_path):
    """--data_parallel in the 2-rank world, each rank's environment as
    torchrun sets it: rank 0 alone opens files under --save_dir, each once,
    and they are the single-process run's files, its results within 1e-5."""
    got = [r["cli"] for r in worlds["data2"]]
    assert [g["rc"] for g in got] == [0, 0]
    assert got[1]["opened"] == []
    opened = got[0]["opened"]
    assert len(opened) == len(set(opened)), opened
    single = tmp_path / "single"
    assert cli.main(W.cli_args(synth_root, str(single))) == 0
    written = {os.path.relpath(os.path.join(d, f), single)
               for d, _, fs in os.walk(single) for f in fs}
    assert set(opened) == written and "inference_results.json" in written
    want = json.loads((single / "inference_results.json").read_text())
    for g in got:
        assert g["results"].keys() == want.keys()
        for path, tasks in want.items():
            for t, d in tasks.items():
                assert g["results"][path][t]["predicted_class"] == d["predicted_class"]
                assert abs(g["results"][path][t]["probability"] - d["probability"]) <= 1e-5


@pytest.mark.parametrize("mode", ["serve", "camera", "watch_folder", "export"])
def test_cli_data_parallel_one_process_modes_raise(synth_root, tmp_path, monkeypatch, mode):
    """Under a world of several processes, the modes that serve or watch a
    live source, and export, refuse --data_parallel before any process
    group is joined."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match=f"--mode {mode} runs in one process"):
        cli.main(["pmg", "--mode", mode, "--build_classifier",
                  os.path.join(synth_root, "tasks.json"), "--save_dir", str(tmp_path),
                  "--device", "cpu", "--data_parallel"])
