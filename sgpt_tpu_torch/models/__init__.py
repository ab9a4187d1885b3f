from .config import DecoderConfig, bloom, from_jax_config, gpt_j_6b, gpt_neo, tiny
from .decoder import Decoder
from .params import aux_from_jax, init_params, param_shapes, params_from_jax

__all__ = ["DecoderConfig", "bloom", "from_jax_config", "gpt_j_6b", "gpt_neo", "tiny",
           "Decoder", "aux_from_jax", "init_params", "param_shapes", "params_from_jax"]
