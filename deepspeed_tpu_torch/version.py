__version__ = "0.3.11"
__version_major__ = 0
__version_minor__ = 3
__version_patch__ = 11
git_hash = "unknown"
git_branch = "unknown"
