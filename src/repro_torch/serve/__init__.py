"""Batched serving of the port: `repro_torch.serve.engine.ServeEngine`."""
