from .type_mapper import ChemicalSpeciesToAtomTypeMapper

__all__ = ["ChemicalSpeciesToAtomTypeMapper"]
