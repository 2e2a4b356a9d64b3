"""HTTP API server of the port: the /vrgdg/... route groups that reach
the device, on aiohttp."""

from .routes import create_app, main

__all__ = ["create_app", "main"]
