from .serve_step import kv_transfer_body, make_kv_transfer, make_serve_steps  # noqa: F401
