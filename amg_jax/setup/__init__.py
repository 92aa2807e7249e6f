from amg_jax.setup.hierarchy import Hierarchy, HierarchyParams, Level, build_hierarchy

__all__ = ["Hierarchy", "HierarchyParams", "Level", "build_hierarchy"]
