from .store import save, restore, latest_step
