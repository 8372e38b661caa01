from .filter_service import FilterBank, FilterService, BankRegistry, bank_probe

__all__ = ["FilterBank", "FilterService", "BankRegistry", "bank_probe"]
