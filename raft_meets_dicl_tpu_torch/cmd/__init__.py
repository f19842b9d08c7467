from . import serve as serve_mod

serve = serve_mod.serve

__all__ = ["serve"]
