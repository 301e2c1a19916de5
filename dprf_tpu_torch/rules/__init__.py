"""Rule engine for wordlist+rules attacks (benchmark config 3).

The rule language is the hashcat/John syntax: one rule per line, a rule
being a sequence of single-character operations with positional and
character parameters.

- ``parser``: rule text -> op tuples, and the built-in rule sets
  (``data/*.rule``, selectable by name as ``--rules best64``);
- ``cpu``: the host interpreter, the correctness oracle;
- ``device``: one rule over a batch of words on torch tensors, the
  plain version of the rule kernel's interpreter (csrc/rules.cu).
"""

from dprf_tpu_torch.rules.parser import (BUILTIN_RULESETS, OPS,  # noqa: F401
                                         Op, Opcode, OpSpec,
                                         builtin_ruleset, load_rules,
                                         parse_rule, parse_rules,
                                         resolve_rules_path)
from dprf_tpu_torch.rules.cpu import apply_rule as apply_rule_cpu  # noqa: F401
