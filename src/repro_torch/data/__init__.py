from .pipeline import RequestStream, ServeRequest

__all__ = ["ServeRequest", "RequestStream"]
