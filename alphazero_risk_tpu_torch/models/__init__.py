"""Policy/value network and its BN-folded bf16/int8 inference path."""
