"""Jobspec — HCL job files → Job structs.

Reference: jobspec2/parse.go:19 (HCL2 with variables/locals/functions)
and jobspec/parse.go (stanza shapes).
"""

from .parse import JobspecError, parse_duration, parse_job, parse_job_file

__all__ = ["JobspecError", "parse_duration", "parse_job", "parse_job_file"]
