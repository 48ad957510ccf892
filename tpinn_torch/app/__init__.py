"""tpinn_torch.app — serving of trained checkpoints (app.serve)."""
