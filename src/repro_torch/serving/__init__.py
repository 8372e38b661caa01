from .filter_service import FilterBank, FilterService, BankRegistry, bank_probe
from .prefix_cache import TieredPrefixCache, TierSpec
from .engine import ServeEngine, Request

__all__ = ["FilterBank", "FilterService", "BankRegistry", "bank_probe",
           "TieredPrefixCache", "TierSpec", "ServeEngine", "Request"]
