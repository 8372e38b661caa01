from .filter_service import FilterBank, FilterService, BankRegistry, bank_probe
from .prefix_cache import TieredPrefixCache, TierSpec

__all__ = ["FilterBank", "FilterService", "BankRegistry", "bank_probe",
           "TieredPrefixCache", "TierSpec"]
