"""The LM scaffold's models (port of `repro.models`): layers, attention,
MoE, Mamba, RWKV-6, the assembled families and the `Model` facade."""
