from .store import ModelRegistry, RegistryError  # noqa: F401
