from .engine import Request, ServeConfig, ServingEngine
