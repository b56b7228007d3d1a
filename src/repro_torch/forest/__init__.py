"""Decision-forest-to-CAM compilation (the flagship non-KNN workload).

Each root-to-leaf path of a decision tree is a conjunction of
per-feature threshold tests — exactly one analog-CAM row of
``[lo, hi]`` intervals (Pedretti et al., *Tree-based machine learning
performed in-memory with memristive analog CAM*).  A whole forest
flattens into one interval gallery; inference is a single aCAM range
search (one match line per branch) followed by a majority class vote,
both on the GPU by default.  See ``docs/forest.md``.
"""

from .forest import (CamForestClassifier, ForestIntervals, TreeArrays,
                     forest_to_intervals, from_sklearn, random_forest,
                     traverse_matches, tree_to_intervals, vote,
                     vote_device)

__all__ = ["CamForestClassifier", "ForestIntervals", "TreeArrays",
           "forest_to_intervals", "from_sklearn", "random_forest",
           "traverse_matches", "tree_to_intervals", "vote", "vote_device"]
