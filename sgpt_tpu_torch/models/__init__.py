from .clip import (CLIPConfig, CLIPEncoder, clip_config_from_hf, clip_from_jax, clip_tiny,
                   clip_vit_b_32, convert_hf_clip, init_clip_params)
from .config import DecoderConfig, bert, bloom, from_jax_config, gpt_j_6b, gpt_neo, t5, tiny
from .decoder import Decoder
from .hf_loader import config_from_hf, convert_hf_state_dict, guess_family, load_pretrained
from .params import (aux_from_jax, head_from_jax, init_params, param_shapes, params_from_jax,
                     tsdae_from_jax)

__all__ = ["DecoderConfig", "bert", "bloom", "from_jax_config", "gpt_j_6b", "gpt_neo", "t5",
           "tiny", "Decoder", "aux_from_jax", "head_from_jax", "init_params", "param_shapes",
           "params_from_jax", "tsdae_from_jax",
           "convert_hf_state_dict", "config_from_hf", "load_pretrained", "guess_family",
           "CLIPConfig", "CLIPEncoder", "clip_vit_b_32", "clip_tiny", "init_clip_params",
           "convert_hf_clip", "clip_config_from_hf", "clip_from_jax"]
