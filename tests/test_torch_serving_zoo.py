"""Every zoo model through the port's serving artifact, and its int8 store,
against the JAX package on the same transplanted weights (CPU, f32).

The cases are ``tests/test_deploy.py::_zoo_export_cases`` (every name of
``MODEL_NAMES`` at 2 layers, hidden 32, and the hamburger with persistent
EMA bases) plus the MoE ViT.  For each:

* one ``serving.pt2`` (``torch.export``, symbolic batch) serves B = 1, 3, 8
  with the logits of JAX's jitted eval path (``deploy._inference_fn``) to
  rtol/atol 1e-5, JAX's own export bound (JAX runs the 12 images as one
  batch, but each served batch on its own for AFT-Full, whose eval couples
  a batch's examples).  The models whose eval draws
  (the hamburger's and the gated NNMF ham's fresh bases from a seed-0
  generator, which JAX takes from ``PRNGKey(0)``: the two streams differ)
  equal the port's own eager eval path instead, exactly;
* ``quantize_weights`` picks the tensors that JAX's ``_quantize_store``
  picks, as many, with equal int8 values and scales equal to rtol 1e-7
  once laid out as flax's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_cifar_torch.config as tconfig
from vit_cifar_torch.data.augment import normalize
from vit_cifar_torch.deploy import export_model, load_inference, \
    quantize_weights
from vit_cifar_torch.models import get_model as torch_get_model
from vit_cifar_torch.utils.transplant import flax_from_state_dict, flax_layout
from vit_cifar_tpu.config import MODEL_NAMES, Config
from vit_cifar_tpu.deploy import _inference_fn, _quantize_store
from vit_cifar_tpu.models import get_model
from test_torch_nnmf import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
# the models whose eval path draws: fresh bases every call
DRAWS = ("hamburger", "hamburger_attention", "gnnmf_ham")
# AFT-Full's max over the batch axis couples the examples of a batch
# (ops/aft.py): JAX runs each served batch on its own
BATCH_COUPLED = ("aftfull",)
SLICES = ((0, 1), (1, 4), (4, 12))  # B = 1, 3, 8


def _cases():
    """``tests/test_deploy.py::_zoo_export_cases``, plus the MoE ViT."""
    cases = []
    for name in MODEL_NAMES:
        kw = {"model_name": name}
        if name.startswith(("hamburger", "gnnmf")) or name == "ae":
            kw.update(head=1, ffn_features=16, md_iter=2)
        if name.startswith("aft"):
            kw.update(head=1)
        if name in ("gmlp", "wgmlp", "linear", "ae_baseline"):
            kw.update(ffn_features=16)
        if name == "lgcnn":
            kw.update(ffn_features=16, kernel_size=3)
        if name == "wlgcnn":
            kw.update(ffn_features=64, kernel_size=3)
        cases.append((name, kw))
    cases.append(("hamburger_ema", {"model_name": "hamburger", "head": 1,
                                    "ffn_features": 16, "md_iter": 2,
                                    "train_md_bases": True}))
    cases.append(("vit_moe", {"model_name": "vit", "moe_experts": 4}))
    return cases


CASES = _cases()


@pytest.mark.parametrize("label,kw", CASES, ids=[c[0] for c in CASES])
def test_zoo_artifact_and_int8_store_match_jax(tmp_path, label, kw):
    cfg = Config(**{"num_layers": 2, "hidden": 32, "mlp_hidden": 32,
                    "head": 4, "patch": 8, "precision": "32", **kw})
    model, _ = get_model(cfg)
    # the port's initial weights carried into flax's collections (faster
    # than flax's init, which runs op by op)
    tcfg = tconfig.Config.from_json(cfg.to_json())
    tmodel, _ = torch_get_model(tcfg, device="cpu")
    params = flax_from_state_dict(tmodel)
    model_state = {c: t for c in ("batch_stats", "state")
                   if (t := flax_from_state_dict(tmodel, collection=c))}

    # the int8 store, before the export takes the model
    store, n_q = _quantize_store(params)
    ours = quantize_weights(tmodel)
    owners = dict(tmodel.named_modules())
    assert len(ours) == n_q, label
    for path, entry in store.items():
        if entry[0] != "int8":
            continue
        q, s = ours[".".join(path[:-1] + ("weight",))]
        _, perm = flax_layout(owners[".".join(path[:-1])], "weight")
        np.testing.assert_array_equal(q.numpy().transpose(perm), entry[1])
        np.testing.assert_allclose(s.numpy().transpose(perm), entry[2],
                                   rtol=1e-7, atol=0)

    imgs = np.random.default_rng(2).integers(0, 256, (12, 32, 32, 3),
                                             dtype=np.uint8)
    if label in DRAWS:
        x = normalize(torch.from_numpy(imgs), cfg.mean, cfg.std)
        with torch.no_grad():
            want = np.concatenate([tmodel(x[a:b], deterministic=True).numpy()
                                   for a, b in SLICES])
    else:
        infer = jax.jit(_inference_fn(cfg, model, params, model_state))
        parts = SLICES if label in BATCH_COUPLED else ((0, 12),)
        want = np.concatenate([np.asarray(infer(jnp.asarray(imgs[a:b])))
                               for a, b in parts])
    served = load_inference(export_model(tmodel, tcfg, str(tmp_path), "cpu"),
                            device="cpu")
    got = np.concatenate([served.predict(imgs[a:b]) for a, b in SLICES])
    assert got.shape == (12, cfg.num_classes)
    if label in DRAWS:
        np.testing.assert_array_equal(got, want, err_msg=label)
    else:
        np.testing.assert_allclose(got, want, **TOL, err_msg=label)
