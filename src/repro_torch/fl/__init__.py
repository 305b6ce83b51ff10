from repro_torch.fl.server import apply_server_opt, init_server_state

__all__ = ["apply_server_opt", "init_server_state"]
