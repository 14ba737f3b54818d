"""Policy registry (counterpart of
``deepspeed_tpu/module_inject/replace_policy.py``): the same order."""

from deepspeed_tpu_torch.module_inject.policy import (
    BertPolicy, BloomPolicy, CLIPPolicy, DistilBertPolicy, GPT2Policy,
    GPTJPolicy, GPTNeoPolicy, GPTNeoXPolicy, LlamaPolicy, MegatronGPT2Policy,
    MegatronGPTMoEPolicy, OPTPolicy)

POLICIES = [GPT2Policy, OPTPolicy, BloomPolicy, GPTJPolicy, GPTNeoPolicy,
            CLIPPolicy,
            GPTNeoXPolicy, LlamaPolicy, MegatronGPTMoEPolicy,
            MegatronGPT2Policy, BertPolicy,
            DistilBertPolicy]


def policy_for(hf_config):
    for pol in POLICIES:
        if pol.matches(hf_config):
            return pol
    raise ValueError(
        f"no ingestion policy for model_type="
        f"{getattr(hf_config, 'model_type', None)!r}; supported: "
        f"{[p.model_type for p in POLICIES]} "
        f"(+ the AutoTP structural fallback for llama-shaped decoders)")
