"""tpinn_torch.core — solver library modules ported from tpinn.core."""
