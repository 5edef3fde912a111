"""Flash attention (FA-2 forward): GQA, causal, optional tanh softcap."""
