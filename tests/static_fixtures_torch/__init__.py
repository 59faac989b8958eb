"""Torch fixture modules for repro_torch.analysis unit tests.

Each ``*_bad.py`` plants torch's forms of its family's hazards, each
marked by a trailing ``# RULE`` comment naming the rule that must fire
on that line (and no other line may fire); each ``*_good.py`` does the
same job the disciplined way and must stay finding-free.  The analyzer
only parses these files: nothing here is imported or run.
"""
