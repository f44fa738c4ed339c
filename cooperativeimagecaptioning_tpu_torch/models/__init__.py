"""Model zoo of the port (counterpart of the JAX package's models/): the
Att2in2 and FC speakers and the VSE listener."""

from cooperativeimagecaptioning_tpu_torch.models import (
    att_model, fc_model, vse)


def setup(opt, name, model_type):
    """Return the model class for a model name (ref models/__init__.py): an
    nn.Module built from a param tree, with `init_params(seed, opt)` making
    one.  A speaker is built as `cls(params)`, the listener as
    `cls(params, opt)`."""
    if model_type == "caption_model":
        if name == "fc":
            return fc_model.FCModel
        if name == "att2in2":
            return att_model.AttModel
        raise ValueError(f"caption model not supported: {name}")
    if model_type == "vse_model":
        if name == "fc":
            return vse.VSEModel
        raise ValueError(f"vse model not supported: {name}")
    raise ValueError(f"model_type not supported: {model_type}")
