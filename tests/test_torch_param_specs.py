"""The models' partition specs (models/{encoder,decoder}.py param_specs)
against the JAX package's: one entry a state-dict leaf, the mesh-axis names
of the JAX ``PartitionSpec`` at the same path, at most one name a
dimension of the leaf, and every name an axis of the ('data', 'model')
mesh."""

import jax
import pytest
from jax.sharding import PartitionSpec

from omni_recall_tpu.models import decoder as jdec
from omni_recall_tpu.models import encoder as jenc
from omni_recall_tpu_torch.models import decoder as tdec
from omni_recall_tpu_torch.models import encoder as tenc

ENC = tenc.EncoderConfig(vocab_size=64, d_model=16, n_layers=2, n_heads=2, d_ff=32,
                         max_len=8, out_dim=12)
DEC = tdec.DecoderConfig(d_model=16, n_layers=3, n_heads=2, d_ff=32, max_len=16)


def _flat_jax_specs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    out = {}
    for path, spec in leaves:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[key] = tuple(spec)
    return out


@pytest.mark.parametrize("model", ["encoder", "decoder"])
def test_param_specs_match_jax_and_the_state_dict(model):
    if model == "encoder":
        specs, jspecs = tenc.param_specs(ENC), jenc.param_specs(jenc.EncoderConfig(**vars(ENC)))
        state = tenc.init_params(0, ENC)
    else:
        specs, jspecs = tdec.param_specs(DEC), jdec.param_specs(jdec.DecoderConfig(**vars(DEC)))
        state = tdec.init_params(0, DEC)
    assert specs == _flat_jax_specs(jspecs)
    assert set(specs) == set(state)
    for key, spec in specs.items():
        assert len(spec) <= state[key].dim(), key
        assert set(spec) <= {None, "data", "model"}, key
        for dim, axis in zip(state[key].shape, spec):
            assert axis is None or dim % 2 == 0, key  # splits over a 2-way 'model' axis
