"""The port's ``parallel/`` on two gloo ranks against the reference package's
``parallel/`` on a 2-device slice of the 8-device CPU platform that
``tests/conftest.py`` sets up: ``attribute_on_mesh`` alone, under
``chunk_starts`` through ``attribute_chunked``'s ``solve_fn`` and on a 1 x 2
mesh (the model axis, ``shard_model=True``, also with ``remat``),
``generate_on_mesh``, three
data-parallel training steps at batch 8 (whole minibatch-stddev groups a rank)
and at batch 4 (contiguous rows, gathered at the stddev layer); a 1 x 2
synthesis and its gradient against the unsharded port; a tiny BigGAN on the
1 x 2 mesh (replicated) against one process; the engine on the data mesh
against the one-device engine; and the rules of ``make_mesh`` and the
divisibility errors, which need no ranks.

The two ranks run once, in one module fixture: this file, run as a script, is
the worker (gloo, ``file://`` rendezvous in the fixture's temporary
directory, so no port is taken).  Both packages get the same numpy inputs:
the port's pipeline weights, basis and noise, restart starts and training
draws drawn by JAX.  Where the port draws itself (a mesh solve from a
generator, the generation latents, the training runners), the two-rank run
is held against the port's single-process run from the same generator.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
    AttributionConfig,
    FingerprintConfig,
    ModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    attribute as attr,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    pipeline as pl,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import biggan as bg
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import stylegan2 as sg2
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.parallel import mesh as pm
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.parallel import (
    multihost as mh,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.parallel import solver as ps
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.parallel import train as pt
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.serving import (
    InferenceEngine,
    ServeConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.training import gan
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.utils.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MKW = dict(img_size=16, channel_max=64, n_mlp=2, style_dim=64)
FKW = dict(key_len=8, shift=56, sigma=1.0, n_pca_samples=500)
S_, N_ = 4, 2  # samples, restarts
ACFG = AttributionConfig(steps=2, n_starts=N_, loss="mse")
TKW = dict(img_size=16, style_dim=32, n_mlp=2, channel_max=32)
TCFG = gan.TrainConfig(batch=8, d_reg_every=2, ema_decay=0.9)
TRAIN_STEPS = 3
# 8 on two ranks: two whole minibatch-stddev groups a rank; 4: one group, gathered at the stddev layer
BATCHES = (8, 4)
# a 32px BigGAN with attention before its last layer, the one chip_smoke.py's phase 12 solves
TINY_BIGGAN = dict(z_dim=32, class_embed_dim=16, channel_width=8, num_classes=10, output_dim=32,
                   attention_layer_position=2, layers=((True, 16, 16), (True, 16, 8), (True, 8, 4)), n_stats=5)
FIELDS = ("alpha", "key_logits", "key_bits", "loss", "losses_all", "best_start")
SERVE = ServeConfig(buckets=(2, 4))


def _states_equal(mesh, state) -> bool:
    """Whether every rank holds the same parameters, EMA and Adam states (a
    float64 checksum a tree, gathered)."""
    trees = (state.g_params, state.d_params, state.g_ema, state.g_opt["mu"], state.g_opt["nu"],
             state.d_opt["mu"], state.d_opt["nu"])
    sums = torch.stack([torch.stack([leaf.double().sum() for leaf in tree_leaves(t)]).sum() for t in trees])
    every = pm.all_gather_rows(mesh, sums[None])
    return bool((every == every[0]).all())


def _tp_synthesis(params, pipe, wx, cot, remat=False):
    """Images of latents ``wx`` and the gradient of <images, cot> in them."""
    w = wx.clone().requires_grad_(True)
    imgs = sg2.synthesis(params, w[:, None].expand(-1, pipe.mcfg.n_latent, -1), pipe.noise, remat=remat)
    (g,) = torch.autograd.grad((imgs * cot).sum(), w)
    return imgs.detach(), g


def _serve(engine, image):
    """A generate and an attribute request through a started engine."""
    gen, dec = engine.generate(seed=7), engine.attribute(image)
    return {"serve_image": gen["image"], "serve_gen_bits": gen["key_bits"], "serve_key_bits": dec["key_bits"],
            "serve_loss": np.float32(dec["loss"])}


def _pipe():
    """The pipeline both ranks and the test build: drawn on the CPU from fixed seeds."""
    pipe = pl.build_pipeline(ModelConfig(**MKW), FingerprintConfig(**FKW), generator=torch.Generator().manual_seed(0),
                             device="cpu", want_lpips=False)
    imgs = pl.generate_fingerprinted(pipe, S_, torch.Generator().manual_seed(1))[0]
    return pipe, imgs


def _biggan_pipe():
    """The tiny BigGAN pipeline both ranks and the test build, and its two targets."""
    pipe = pl.build_pipeline(ModelConfig(model="biggan", img_size=32, biggan_label="3"),
                             FingerprintConfig(key_len=8, shift=24, sigma=1.0, n_pca_samples=500),
                             generator=torch.Generator().manual_seed(1), device="cpu", want_lpips=False,
                             biggan_cfg=bg.BigGANConfig(**TINY_BIGGAN))
    return pipe, pl.generate_fingerprinted(pipe, 2, torch.Generator().manual_seed(2))[0]


def _biggan_on_mesh(mesh, pipe, targets):
    """Generation and a 2-step mse solve of the tiny BigGAN on ``mesh``, the model axis engaged."""
    gen = ps.generate_on_mesh(mesh, ps.place_pipeline(mesh, pipe, shard_model=True), 2,
                              torch.Generator().manual_seed(9))[0]
    res = ps.attribute_on_mesh(mesh, pipe.gen_params, None, pipe.basis, pipe.noise, targets, mcfg=pipe.mcfg,
                               acfg=ACFG, generator=torch.Generator().manual_seed(5), shard_model=True,
                               **pl.solver_kwargs(pipe))
    return gen, res


def _with_basis(pipe, inp, prefix):
    """``pipe`` with the basis the test process computed (a PCA run at another thread count rounds otherwise)."""
    return dataclasses.replace(pipe, basis=dataclasses.replace(pipe.basis, **{
        f.name: torch.from_numpy(inp[prefix + f.name]) for f in dataclasses.fields(pipe.basis)
        if torch.is_tensor(getattr(pipe.basis, f.name))}))


def _d_grad(state) -> np.ndarray:
    """D's gradient in the step just taken from a fresh state: Adam's first
    moment after one update is the gradient itself (beta1 = 0)."""
    return torch.cat([m.reshape(-1) for m in tree_leaves(state.d_opt["mu"])]).numpy()


def _port_draws(d, g, real):
    def phase(z, t, use_mix, noise):
        return gan.PhaseDraws(torch.from_numpy(z), torch.from_numpy(t).long(), torch.from_numpy(use_mix),
                              [torch.from_numpy(n) for n in noise])

    return {"real": torch.from_numpy(real), "d": phase(*d), "g": phase(*g)}


def _phase_arrays(inp, batch, j, which):
    key = f"b{batch}_{which}{j}"
    n = len([k for k in inp if k.startswith(f"{key}_noise")])
    return (inp[f"{key}_z"], inp[f"{key}_t"], inp[f"{key}_use_mix"], [inp[f"{key}_noise{i}"] for i in range(n)])


def _step_draws(inp, batch, j):
    """Step ``j``'s global draws at ``batch`` (JAX's), the reals the first ``batch`` rows of a stack of 8."""
    return _port_draws(_phase_arrays(inp, batch, j, "d"), _phase_arrays(inp, batch, j, "g"),
                       inp["reals"][j, :batch])


def _worker(tmp: str, rank: int) -> None:
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False  # PyTorch's direct CPU convs, as the parity tests use
    mh.initialize(f"file://{tmp}/rendezvous", 2, rank, device="cpu")
    mesh = mh.global_mesh()
    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    pipe = _with_basis(_pipe()[0], inp, "basis_")
    targets = torch.from_numpy(inp["targets"])
    a0 = torch.from_numpy(inp["a0"])
    out = {"mesh_shape": np.asarray([mesh.shape["data"], mesh.shape["model"]]), "index": mesh.index("data")}

    def keep(tag, res):
        for f in FIELDS:
            out[f"{tag}_{f}"] = getattr(res, f).numpy()

    def solve_fn(tgt, generator, **kw):
        return ps.attribute_on_mesh(mesh, pipe.gen_params, None, pipe.basis, pipe.noise, tgt,
                                    mcfg=pipe.mcfg, acfg=ACFG, generator=generator, **kw)

    common = (pipe.gen_params, None, pipe.basis, pipe.noise, targets)
    keep("on_mesh", ps.attribute_on_mesh(mesh, *common, mcfg=pipe.mcfg, acfg=ACFG, alpha_init=a0))
    keep("drawn", ps.attribute_on_mesh(mesh, *common, mcfg=pipe.mcfg, acfg=ACFG,
                                       generator=torch.Generator().manual_seed(5)))
    keep("chunked", attr.attribute_chunked(*common, mcfg=pipe.mcfg, acfg=ACFG, chunk_starts=1, solve_fn=solve_fn,
                                           alpha_init=a0))
    keep("chunked_drawn", attr.attribute_chunked(*common, mcfg=pipe.mcfg, acfg=ACFG, chunk_starts=1,
                                                 solve_fn=solve_fn, generator=torch.Generator().manual_seed(5)))
    gen = ps.generate_on_mesh(mesh, ps.place_pipeline(mesh, pipe), S_, torch.Generator().manual_seed(9))
    for name, x in zip(("imgs", "w0", "wx", "bits", "alpha"), gen):
        out["gen_" + name] = x.numpy()
    # the multi-host entry points: this rank's own targets in, the global result out
    keep("multihost", mh.attribute_multihost(mesh, pipe.gen_params, None, pipe.basis, pipe.noise,
                                             mh.shard_local_batch(mesh, targets[2 * rank:2 * rank + 2]),
                                             mcfg=pipe.mcfg, acfg=ACFG, alpha_init=a0))
    out["multihost_imgs"] = mh.generate_multihost(mesh, pipe, S_, torch.Generator().manual_seed(9))[0].numpy()
    mh.train_multihost_chunk_runners(mesh, ModelConfig(**TKW), TCFG)

    tm = ModelConfig(**TKW)
    gather_rows, gathered = sg2.gather_rows, []

    def counted_gather(x, mesh):
        gathered.append(x.shape[0])
        return gather_rows(x, mesh)

    for b in BATCHES:
        tcfg = dataclasses.replace(TCFG, batch=b)
        out[f"rows_{b}"] = rows = pt.batch_rows(mesh, b).numpy()
        state = pt.place_train_state(mesh, gan.init_train_state(tm, tcfg, torch.Generator().manual_seed(0), "cpu"))
        metrics, gathered[:] = [], []
        sg2.gather_rows = counted_gather
        try:
            for j in range(TRAIN_STEPS):
                state, m = gan.train_step(state, gan.shard_draws(_step_draws(inp, b, j), torch.from_numpy(rows)), tm,
                                          tcfg, mesh=mesh)
                metrics.append([float(m[k]) for k in ("d_loss", "r1", "g_loss")])
                if j == 0:  # an R1 step
                    out[f"d_grad_{b}"] = _d_grad(state)
        finally:
            sg2.gather_rows = gather_rows
        out[f"stddev_gathers_{b}"] = np.asarray(gathered)
        out[f"train_metrics_{b}"] = np.asarray(metrics)
        out[f"train_states_equal_{b}"] = _states_equal(mesh, state)
        run_chunk, run_chunk_data = pt.make_mesh_chunk_runners(mesh, tm, tcfg)
        state = pt.place_train_state(mesh, gan.init_train_state(tm, tcfg, torch.Generator().manual_seed(0), "cpu"))
        m = run_chunk(state, 3, 2)
        m2 = run_chunk_data(state, 3, pt.shard_reals(mesh, inp["reals"][:1, :b]))
        out[f"runner_metrics_{b}"] = np.stack([np.concatenate([m[k], m2[k]]) for k in ("d_loss", "r1", "g_loss")])
        out[f"runner_states_equal_{b}"] = _states_equal(mesh, state)
    out["allgather"] = mh.process_allgather(torch.full((1, 2), float(rank)))
    with pytest.raises(ValueError, match="mesh 3x1 needs 3 devices, have 2"):
        pm.make_mesh(data=3)

    # the model axis: each rank half of every styled conv's output channels
    mesh12 = pm.make_mesh(data=1, model=2)
    assert mesh12.shape == {"data": 1, "model": 2} and mesh12.index("model") == rank
    sharded = pm.shard_generator_params(mesh12, pipe.gen_params)
    assert sharded["convs"][0]["weight"].shape[-1] * 2 == pipe.gen_params["convs"][0]["weight"].shape[-1]
    out["tp_imgs"], out["tp_grad"] = (t.numpy() for t in _tp_synthesis(
        sharded, pipe, torch.from_numpy(out["gen_wx"]), torch.from_numpy(inp["cot"])))
    keep("tp", ps.attribute_on_mesh(mesh12, *common, mcfg=pipe.mcfg, acfg=ACFG, alpha_init=a0, shard_model=True))
    # with gradient checkpointing: the backward runs each block's gathers again, on both ranks
    out["tp_remat_imgs"], out["tp_remat_grad"] = (t.numpy() for t in _tp_synthesis(
        sharded, pipe, torch.from_numpy(out["gen_wx"]), torch.from_numpy(inp["cot"]), remat=True))
    keep("tp_remat", ps.attribute_on_mesh(mesh12, *common, mcfg=pipe.mcfg, acfg=ACFG, alpha_init=a0,
                                          shard_model=True, remat=True))
    # BigGAN on the model axis: replicated, as the reference places it
    bpipe = _with_basis(_biggan_pipe()[0], inp, "biggan_basis_")
    assert pm.shard_generator_params(mesh12, bpipe.gen_params) is bpipe.gen_params
    imgs, res = _biggan_on_mesh(mesh12, bpipe, torch.from_numpy(inp["biggan_targets"]))
    out["biggan_imgs"] = imgs.numpy()
    keep("biggan", res)

    # the engine on the data mesh: rank 0 runs the queue, rank 1 follows its batches
    engine = InferenceEngine(pipe, acfg=ACFG, cfg=SERVE, seed=3, mesh=mesh)
    if rank == 0:
        engine.start()
        try:
            out.update(_serve(engine, targets[0].numpy()))
        finally:
            engine.stop()
    else:
        engine.follow()
    np.savez(os.path.join(tmp, f"out_{rank}.npz"), **out)


def _jax_train_draws(key, jmcfg, batch, mixing):
    """The draws of the reference package's step for ``key``, split as it splits them."""
    import jax

    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.models import stylegan2 as jsg2

    _, k_lat_d, k_noise_d, k_lat_g, k_noise_g = jax.random.split(key, 5)

    def phase(k_lat, k_noise):
        kz, kt, kp = jax.random.split(k_lat, 3)
        return (np.array(jax.random.normal(kz, (2, batch, jmcfg.style_dim))),
                np.array(jax.random.randint(kt, (batch,), 1, jmcfg.n_latent)),
                np.array(jax.random.bernoulli(kp, mixing, (batch,))),
                [np.array(n) for n in jsg2.make_noise(k_noise, jmcfg.img_size)])

    return phase(k_lat_d, k_noise_d), phase(k_lat_g, k_noise_g)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Inputs drawn by JAX, the two ranks' outputs, and the JAX package's
    parallel functions on the same inputs."""
    import jax
    import jax.numpy as jnp

    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
        AttributionConfig as JAttributionConfig,
    )
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
        ModelConfig as JModelConfig,
    )
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import (
        attribute as jattr,
    )
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import embed as jembed
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import pipeline as jpl
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.parallel import mesh as jpm
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.parallel import solver as jsolver
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.parallel import train as jtrain
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.training import gan as jgan
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.utils.lhs import (
        lhs_alpha_init_batch,
    )

    tmp = str(tmp_path_factory.mktemp("parallel"))
    pipe, targets = _pipe()
    a0 = np.asarray(lhs_alpha_init_batch(jax.random.PRNGKey(2), S_, N_, jnp.asarray(pipe.basis.sigma_rest.numpy())))
    jtm = JModelConfig(**TKW)
    base = jax.random.PRNGKey(7)
    inp = {"a0": a0, "reals": np.random.default_rng(0).uniform(-1, 1, (TRAIN_STEPS, 8, 16, 16, 3)).astype(np.float32),
           "targets": targets.numpy(), "cot": np.random.default_rng(1).standard_normal((S_, 16, 16, 3)).astype(
               np.float32), **{"basis_" + f.name: getattr(pipe.basis, f.name).numpy()
                               for f in dataclasses.fields(pipe.basis) if f.name != "sd_moved"}}
    for b in BATCHES:
        for j in range(TRAIN_STEPS):
            for which, (z, t, use_mix, noise) in zip("dg", _jax_train_draws(jax.random.fold_in(base, j), jtm, b,
                                                                           TCFG.mixing)):
                key = f"b{b}_{which}{j}"
                inp.update({f"{key}_z": z, f"{key}_t": t, f"{key}_use_mix": use_mix,
                            **{f"{key}_noise{i}": n for i, n in enumerate(noise)}})
    bpipe, btargets = _biggan_pipe()
    inp.update({"biggan_targets": btargets.numpy(), **{"biggan_basis_" + f.name: getattr(bpipe.basis, f.name).numpy()
                                                       for f in dataclasses.fields(bpipe.basis)
                                                       if torch.is_tensor(getattr(bpipe.basis, f.name))}})
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), tmp, str(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]

    # while the ranks run: the reference package's parallel functions on the same inputs, on a 2-device mesh
    jmesh = jpm.make_mesh(data=2, devices=jax.devices()[:2])
    jmcfg, jacfg = JModelConfig(**MKW), JAttributionConfig(steps=ACFG.steps, n_starts=N_, loss="mse")
    jgen = jax.tree.map(lambda t: jnp.asarray(t.numpy()), pipe.gen_params)
    jbasis = jembed.FingerprintBasis(**{
        f.name: jnp.asarray(getattr(pipe.basis, f.name).numpy()) if f.name != "sd_moved" else pipe.basis.sd_moved
        for f in dataclasses.fields(pipe.basis)})
    jnoise = [jnp.asarray(n.numpy()) for n in pipe.noise]
    jt = jnp.asarray(targets.numpy())
    zeros = jnp.zeros((S_, N_, FKW["key_len"]))

    def jsolve_fn(tgt, r, **kw):
        return jsolver.attribute_on_mesh(jmesh, jgen, None, jbasis, jnoise, tgt, r, mcfg=jmcfg, acfg=jacfg, **kw)

    jax_side = {
        "on_mesh": jsolver.attribute_on_mesh(jmesh, jgen, None, jbasis, jnoise, jt, jax.random.PRNGKey(0),
                                             mcfg=jmcfg, acfg=jacfg, alpha_init=jnp.asarray(a0), key_init=zeros),
        "tp": jsolver.attribute_on_mesh(jpm.make_mesh(data=1, model=2, devices=jax.devices()[:2]), jgen, None,
                                        jbasis, jnoise, jt, jax.random.PRNGKey(0), mcfg=jmcfg, acfg=jacfg,
                                        alpha_init=jnp.asarray(a0), key_init=zeros, shard_model=True),
        "chunked": jattr.attribute_chunked(jgen, None, jbasis, jnoise, jt, jax.random.PRNGKey(0), mcfg=jmcfg,
                                           acfg=jacfg, chunk_starts=1, solve_fn=jsolve_fn,
                                           alpha_init=jnp.asarray(a0), key_init=zeros),
    }
    tm = ModelConfig(**TKW)
    state = gan.init_train_state(tm, TCFG, torch.Generator().manual_seed(0), "cpu")
    g, d = (jax.tree.map(lambda v: jnp.asarray(v.numpy()), t) for t in (state.g_params, state.d_params))
    for b in BATCHES:
        jtcfg = jgan.TrainConfig(batch=b, d_reg_every=TCFG.d_reg_every, ema_decay=TCFG.ema_decay)
        opt = jgan._optimizer(jtcfg)
        jstate = jtrain.place_train_state(jmesh, jgan.TrainState(
            step=jnp.zeros((), jnp.int32), g_params=g, d_params=d, g_ema=g, g_opt=opt.init(g), d_opt=opt.init(d)))
        _, run_chunk_data = jtrain.make_mesh_chunk_runners(jmesh, jtm, jtcfg, external_data=True)
        _, jm = run_chunk_data(jstate, base, jnp.int32(0), jtrain.shard_reals(jmesh, inp["reals"][:, :b]))
        jax_side[f"train_metrics_{b}"] = np.stack([np.asarray(jm[k]) for k in ("d_loss", "r1", "g_loss")], axis=1)

    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    outs = [dict(np.load(os.path.join(tmp, f"out_{r}.npz"))) for r in range(2)]
    jpipe = jsolver.place_pipeline(jmesh, jpl.Pipeline(mcfg=jmcfg, fpcfg=None, gen_params=jgen, basis=jbasis,
                                                       pca=None, noise=tuple(jnoise)))
    jax_side["imgs"] = np.asarray(jpl.synthesize(jpipe, jpm.shard_batch(jmesh, jnp.asarray(outs[0]["gen_wx"]))))
    return {"pipe": pipe, "targets": targets, "outs": outs, "jax": jax_side, "inp": inp,
            "biggan": (_with_basis(bpipe, inp, "biggan_basis_"), btargets)}


def test_both_ranks_hold_the_global_results(ranks):
    o0, o1 = ranks["outs"]
    assert list(o0["mesh_shape"]) == [2, 1] and (int(o0["index"]), int(o1["index"])) == (0, 1)
    for k in o0:
        if k not in ("index", "tp_grad", "tp_remat_grad") and not k.startswith(("serve", "rows_")):
            np.testing.assert_array_equal(o0[k], o1[k], err_msg=k)
    for k in ("tp_grad", "tp_remat_grad"):  # summed in rank order
        np.testing.assert_allclose(o0[k], o1[k], rtol=1e-6, atol=1e-7)
    assert not any(k.startswith("serve") for k in o1)  # only rank 0 answers requests
    assert all(o0[f"{tag}_states_equal_{b}"] for tag in ("train", "runner") for b in BATCHES)
    # batch 8: two whole minibatch-stddev groups a rank (columns 0 and 1); batch 4: contiguous rows
    assert [list(o["rows_8"]) for o in (o0, o1)] == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert [list(o["rows_4"]) for o in (o0, o1)] == [[0, 1], [2, 3]]
    np.testing.assert_array_equal(o0["allgather"], [[0, 0], [1, 1]])
    for f in FIELDS:  # the multi-host path is the same solve from each rank's own rows
        np.testing.assert_array_equal(o0[f"multihost_{f}"], o0[f"on_mesh_{f}"], err_msg=f)
    np.testing.assert_array_equal(o0["multihost_imgs"], o0["gen_imgs"])


@pytest.mark.parametrize("tag", ["on_mesh", "chunked", "tp"])
def test_mesh_solve_matches_the_reference_packages(ranks, tag):
    """Two 2-step mse solves from the same JAX-drawn starts, the port's on two
    ranks and JAX's ``attribute_on_mesh`` on two devices: the same key bits
    and winning restarts; losses within 1e-4 relative and alpha within 1e-4
    (two float32 solves of one problem in two frameworks)."""
    o, j = ranks["outs"][0], ranks["jax"][tag]
    assert o[f"{tag}_loss"].shape == (S_,) and o[f"{tag}_losses_all"].shape == (S_, N_)
    np.testing.assert_array_equal(o[f"{tag}_key_bits"], np.asarray(j.key_bits))
    np.testing.assert_array_equal(o[f"{tag}_best_start"], np.asarray(j.best_start))
    np.testing.assert_allclose(o[f"{tag}_losses_all"], np.asarray(j.losses_all), rtol=1e-4)
    np.testing.assert_allclose(o[f"{tag}_loss"], np.asarray(j.loss), rtol=1e-4)
    np.testing.assert_allclose(o[f"{tag}_alpha"], np.asarray(j.alpha), atol=1e-4)


@pytest.fixture
def direct_cpu_convs():
    """The workers' convolutions: PyTorch's direct ones, not oneDNN's."""
    before = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = before


def test_mesh_solve_draws_the_single_process_starts(ranks, direct_cpu_convs):
    """From a generator, each rank draws the starts of all S samples and keeps
    its rows: the two-rank solves (alone and restart-chunked) equal the
    single-process solves from the same generator (1e-6 relative: per-sample
    arithmetic at another batch size)."""
    pipe, targets, o = ranks["pipe"], ranks["targets"], ranks["outs"][0]
    common = (pipe.gen_params, None, pipe.basis, pipe.noise, targets)
    single = {
        "drawn": attr.attribute(*common, mcfg=pipe.mcfg, acfg=ACFG, generator=torch.Generator().manual_seed(5)),
        "chunked_drawn": attr.attribute_chunked(*common, mcfg=pipe.mcfg, acfg=ACFG, chunk_starts=1,
                                                generator=torch.Generator().manual_seed(5)),
    }
    for tag, res in single.items():
        np.testing.assert_array_equal(o[f"{tag}_key_bits"], res.key_bits.numpy(), err_msg=tag)
        np.testing.assert_array_equal(o[f"{tag}_best_start"], res.best_start.numpy(), err_msg=tag)
        np.testing.assert_allclose(o[f"{tag}_losses_all"], res.losses_all.numpy(), rtol=1e-6, err_msg=tag)


def test_generate_on_mesh_matches_single_process_and_reference_synthesis(ranks, direct_cpu_convs):
    """The latents are the single-process draws exactly; the images match the
    port's single-process render (1e-6) and the reference package's synthesis
    of the same latents on its 2-device mesh (1e-4 of the images' range).
    The single-process render is made in the ranks' row blocks (S_ / 2 rows
    each): a GEMM of another batch may sum in another order, which on some
    hosts' BLAS (AMD EPYC) moves the images by up to ~2e-6."""
    o = ranks["outs"][0]
    imgs, w0, wx, bits, alpha = pl.generate_fingerprinted(ranks["pipe"], S_, torch.Generator().manual_seed(9))
    for name, want in (("w0", w0), ("wx", wx), ("bits", bits), ("alpha", alpha)):
        np.testing.assert_array_equal(o["gen_" + name], want.numpy(), err_msg=name)
    half = S_ // 2
    blocks = torch.cat([pl.synthesize(ranks["pipe"], wx[r * half:(r + 1) * half]) for r in range(2)])
    np.testing.assert_allclose(o["gen_imgs"], blocks.numpy(), atol=1e-6)
    np.testing.assert_allclose(o["gen_imgs"], imgs.numpy(), atol=1e-5)
    np.testing.assert_allclose(o["gen_imgs"], ranks["jax"]["imgs"], atol=1e-4)


@pytest.mark.parametrize("batch", BATCHES)
def test_data_parallel_training_matches_the_reference_mesh_step(ranks, batch):
    """Three steps (R1 at steps 0 and 2) from the same weights with JAX's draws:
    the port's two ranks (gradients averaged; at batch 8 each rank holds
    whole minibatch-stddev groups, at batch 4 contiguous rows gathered at the
    stddev layer) against the reference package's mesh chunk runner on two
    devices, whose GSPMD computes the stddev over the global batch.  Metrics,
    not parameters, as ``tests/test_training_mesh.py`` compares them (Adam's
    first updates are ~lr*sign(g)); 1e-4 relative, the tolerance of the
    port's one-step comparison (test_torch_training.py).  Both ranks end in
    the same state."""
    o = ranks["outs"][0]
    got, want = o[f"train_metrics_{batch}"], ranks["jax"][f"train_metrics_{batch}"]
    assert got.shape == (TRAIN_STEPS, 3) and (got[[0, 2], 1] > 0).all() and got[1, 1] == 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert o[f"train_states_equal_{batch}"]
    # the stddev layer's row gathers: none with whole groups, else one a discriminator pass (3 a step) of 2 rows
    assert list(o[f"stddev_gathers_{batch}"]) == ([] if batch == 8 else [2] * 3 * TRAIN_STEPS)


@pytest.mark.parametrize("batch", BATCHES)
def test_mesh_chunk_runners_match_single_process_steps(ranks, direct_cpu_convs, batch):
    """``make_mesh_chunk_runners`` draws every step's global batch from (seed,
    step) and keeps the rank's rows: two synthetic steps and one on given reals
    equal ``run_steps`` in one process (1e-5 relative)."""
    tm, tcfg = ModelConfig(**TKW), dataclasses.replace(TCFG, batch=batch)
    state = gan.init_train_state(tm, tcfg, torch.Generator().manual_seed(0), "cpu")
    m = gan.run_steps(state, 3, 2, tm, tcfg)
    m2 = gan.run_steps(state, 3, 1, tm, tcfg, reals=[torch.from_numpy(ranks["inp"]["reals"][0, :batch])])
    want = np.stack([np.concatenate([m[k], m2[k]]) for k in ("d_loss", "r1", "g_loss")])
    np.testing.assert_allclose(ranks["outs"][0][f"runner_metrics_{batch}"], want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("batch", BATCHES)
def test_data_parallel_d_gradient_with_r1_matches_single_process(ranks, direct_cpu_convs, batch):
    """D's gradient of an R1 step (adversarial loss + R1, a second derivative
    through the discriminator) averaged over the two ranks equals the
    single-process gradient on the global batch (1e-5 of its scale).  At
    batch 4 it runs through the row gather's backward and that backward's own
    backward: each rank's R1 includes the other rank's logits."""
    tm, tcfg = ModelConfig(**TKW), dataclasses.replace(TCFG, batch=batch)
    state = gan.init_train_state(tm, tcfg, torch.Generator().manual_seed(0), "cpu")
    state, m = gan.train_step(state, _step_draws(ranks["inp"], batch, 0), tm, tcfg)
    want = _d_grad(state)
    assert float(m["r1"]) > 0
    np.testing.assert_allclose(ranks["outs"][0][f"d_grad_{batch}"], want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_model_axis_synthesis_and_gradient_match_the_unsharded_port(ranks, direct_cpu_convs):
    """On a 1 x 2 mesh each rank computes half of every styled conv's output
    channels and gathers them; the gradient in the latents sums both ranks'
    parts (the gather's backward is the rank's slice, the convs' inputs and
    styles sum their gradients over "model").  Images within 1e-5, the
    gradient within 1e-5 of its scale, of the unsharded port's."""
    pipe, o = ranks["pipe"], ranks["outs"][0]
    imgs, g = _tp_synthesis(pipe.gen_params, pipe, torch.from_numpy(o["gen_wx"]),
                            torch.from_numpy(np.random.default_rng(1).standard_normal((S_, 16, 16, 3)).astype(
                                np.float32)))
    np.testing.assert_allclose(o["tp_imgs"], imgs.numpy(), atol=1e-5)
    np.testing.assert_allclose(o["tp_grad"], g.numpy(), atol=1e-5 * float(g.abs().max()))


def test_model_axis_with_remat_gives_what_it_gives_without(ranks):
    """``remat`` on a 1 x 2 mesh: each checkpointed block's backward runs its
    forward again, the channel gathers with it, in one order on both ranks.
    The sharded synthesis (images bitwise, its latent gradient within 1e-6 of
    its scale) and the 2-step mse solve (the same key bits and winners, losses
    and alpha within 1e-6) are those without."""
    o = ranks["outs"][0]
    np.testing.assert_array_equal(o["tp_remat_imgs"], o["tp_imgs"])
    np.testing.assert_allclose(o["tp_remat_grad"], o["tp_grad"], atol=1e-6 * float(np.abs(o["tp_grad"]).max()))
    for f in ("key_bits", "best_start"):
        np.testing.assert_array_equal(o[f"tp_remat_{f}"], o[f"tp_{f}"], err_msg=f)
    for f in ("loss", "losses_all", "alpha"):
        np.testing.assert_allclose(o[f"tp_remat_{f}"], o[f"tp_{f}"], rtol=1e-6, atol=1e-7, err_msg=f)


def test_biggan_on_the_model_axis_matches_one_process(ranks, direct_cpu_convs):
    """``--mesh_model 2`` with BigGAN: the reference's placement shards no
    BigGAN leaf, so the 1 x 2 mesh replicates the generator and each rank runs
    the whole network.  Generation and a 2-step mse solve equal the port's
    single-process ``generate_on_mesh`` / ``attribute_on_mesh`` (1e-6); the
    unsharded BigGAN is held against JAX in ``tests/test_torch_biggan.py``."""
    o = ranks["outs"][0]
    imgs, res = _biggan_on_mesh(pm.make_mesh(), *ranks["biggan"])
    np.testing.assert_allclose(o["biggan_imgs"], imgs.numpy(), rtol=1e-6, atol=1e-6)
    for f in ("key_bits", "best_start"):
        np.testing.assert_array_equal(o[f"biggan_{f}"], getattr(res, f).numpy(), err_msg=f)
    for f in ("loss", "losses_all", "alpha", "key_logits"):
        np.testing.assert_allclose(o[f"biggan_{f}"], getattr(res, f).numpy(), rtol=1e-6, atol=1e-6, err_msg=f)


def test_mesh_engine_serves_what_the_one_device_engine_serves(ranks, direct_cpu_convs):
    """The engine on the 2-rank data mesh (buckets 2 and 4; rank 0 queues,
    rank 1 follows) answers a generate and an attribute request as the
    one-device engine does: the same key bits, the image within 1e-5 (a
    rank renders its row at batch 1 on one thread), the loss within 1e-6
    relative."""
    pipe, o = ranks["pipe"], ranks["outs"][0]
    engine = InferenceEngine(pipe, acfg=ACFG, cfg=SERVE, seed=3).start()
    try:
        want = _serve(engine, ranks["targets"][0].numpy())
    finally:
        engine.stop()
    for k in ("serve_gen_bits", "serve_key_bits"):
        np.testing.assert_array_equal(o[k], want[k], err_msg=k)
    np.testing.assert_allclose(o["serve_image"], want["serve_image"], atol=1e-5)
    np.testing.assert_allclose(o["serve_loss"], want["serve_loss"], rtol=1e-6)
    with pytest.raises(ValueError, match=r"buckets \[1\] not divisible by mesh data axis 2"):
        InferenceEngine(pipe, cfg=ServeConfig(buckets=(1, 2)),
                        mesh=pm.Mesh(np.arange(2)[:, None], {"data": None, "model": None}, 0, None))


def test_make_mesh_rules_and_divisibility_errors_without_ranks():
    """No process group: a world of one.  The errors are the reference package's."""
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.parallel import mesh as jpm

    m = pm.make_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.backend is None and m.index("data") == 0
    for kw in (dict(data=5, model=3), dict(model=3)):
        with pytest.raises(ValueError) as want:
            jpm.make_mesh(**kw)
        with pytest.raises(ValueError) as got:
            pm.make_mesh(**kw, ranks=range(8))
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        pm.make_mesh(data=2)
    assert pm.make_mesh(data=4, model=2, ranks=range(8)).shape == {"data": 4, "model": 2}
    two = pm.Mesh(np.arange(2)[:, None], {"data": None, "model": None}, 0, None)  # no collective is reached
    pipe, targets = _pipe()
    with pytest.raises(ValueError, match="sample count 3 not divisible by data axis 2"):
        ps.attribute_on_mesh(two, pipe.gen_params, None, pipe.basis, pipe.noise, targets[:3], mcfg=pipe.mcfg,
                             acfg=ACFG)
    with pytest.raises(ValueError, match="batch 3 not divisible by data axis 2"):
        ps.generate_on_mesh(two, pipe, 3, torch.Generator())
    with pytest.raises(ValueError, match="batch 6 not divisible by data axis 4"):
        pt.make_mesh_chunk_runners(pm.Mesh(np.arange(4)[:, None], {"data": None, "model": None}, 0, None),
                                   ModelConfig(**TKW), dataclasses.replace(TCFG, batch=6))
    # batch 4 on two ranks: one minibatch-stddev group, so contiguous rows (gathered at the stddev layer)
    assert pt.batch_rows(two, 4).tolist() == [0, 1] and sg2.stddev_gathers(4, 2) and not sg2.stddev_gathers(8, 2)
    with pytest.raises(ValueError, match="pass generator= or alpha_init="):
        ps.attribute_on_mesh(two, pipe.gen_params, None, pipe.basis, pipe.noise, targets, mcfg=pipe.mcfg, acfg=ACFG)
    assert mh.process_index() == 0 and mh.process_count() == 1 and mh.global_mesh().shape["data"] == 1


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]))
