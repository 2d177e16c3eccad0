"""Constraint-count cost model + auto batch-size selection.

Mirrors reference src/backend/costs.rs: closed-form per-gadget
constraint estimates and the folded-cost objective
``2*n_fold*(V1+V2+C) + 8*(V1+C)`` minimized over batch sizes (costs.rs:
168-244).  V1/V2 are the Nova verifier-circuit folding overheads
(costs.rs:7-8); retained as documented constants — the real overhead of this
implementation's folding circuit is measured at setup and printed next to the
estimate, as the reference does (framework.rs:313-347).
"""

from __future__ import annotations

import math

# Reference Nova folding-overhead constants (costs.rs:7-8), kept for the
# printed estimate-vs-actual comparison:
V1_REF = 10347
V2_REF = 11376
# THIS implementation's measured per-fold overheads (round 2): the
# augmented-primary fixed part (app base + in-circuit fold verifier +
# rate-8 state hashes, ~24k constraints) and the secondary circuit
# (15,963).  Both larger than the reference's (non-native limb folds and
# two in-circuit 128-bit scalar muls per side), which moves the optimum
# toward LARGER batches: one extra batch element costs ~270 constraints
# against ~40k/fold of fixed overhead.
V1 = 24000
V2 = 16000


def logmn(mn: int) -> int:
    if mn <= 1:
        return 1
    return max(1, math.ceil(math.log2(mn)))


def next_power_of_two(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def get_padding(solution_len: int, batch_size: int) -> int:
    modlen = solution_len + 1
    eps = 0 if modlen % batch_size == 0 else batch_size - (modlen % batch_size)
    return eps + 1


def lookup_idxs_cost(n_states: int, batch_size: int,
                     num_chars: int = 1 << 8) -> int:
    bit_limit = logmn(n_states) + 1
    cbits = logmn(num_chars) + 2     # char_lo <= char <= char_hi checks
    return (bit_limit * (2 * batch_size + 1) + bit_limit * 3 + 5
            + 2 * cbits * batch_size)


def nl_nohash(batch_size: int, table_size: int) -> int:
    log_mn = logmn(table_size)
    cost = batch_size + 1
    cost += log_mn * 2
    cost += (batch_size + 1) * (2 * log_mn)
    cost += (batch_size + 1) * (log_mn - 1)
    cost += batch_size + 1
    cost += 1
    cost += math.ceil(batch_size * log_mn / 254.0)
    return cost


# Fiat-Shamir sponge rate for the nlookup gadgets (t = NL_RATE + 1).
# Rate 8 absorbs the big initial query (batch vs + running q + packed q
# bits) in half the permutations of the reference's arity-4 pattern; the
# per-round absorb(3)+squeeze(1) is one permutation at either rate.  The
# constants deviate from neptune regardless (documented waiver), so only
# self-consistency matters — see PARITY.md.
NL_RATE = 8
_PERM_GADGET_COST = {4: 298, 8: 414}   # stamped constraints per permutation


def nlookup_cost_hash(batch_size: int, table_size: int, hybrid: bool) -> int:
    log_mn = logmn(table_size)
    num_cqs = math.ceil(batch_size * log_mn / 254.0)
    n_abs = batch_size + log_mn + 1 + num_cqs + (1 if hybrid else 0)
    perm = _PERM_GADGET_COST[NL_RATE]
    perms = max(1, math.ceil(n_abs / NL_RATE))   # initial absorb + squeeze
    perms += log_mn                              # one per sumcheck round
    return perms * perm + log_mn * 6 + 290


def nl(batch_size: int, table_size: int, hybrid: bool) -> int:
    return nl_nohash(batch_size, table_size) + nlookup_cost_hash(
        batch_size, table_size, hybrid)


def q_ordering(table_size: int, batch_size: int, hybrid: bool, project: bool) -> int:
    total = logmn(table_size)
    if hybrid:
        total += 1
    if project:
        total += 1
    return total * batch_size


def nl_doc(batch_size: int, table_size: int, hybrid: bool, project: bool) -> int:
    return q_ordering(table_size, batch_size, hybrid, project) + nl(
        batch_size, table_size, hybrid)


def cursor_circuit_cost(doc_len: int, batch_size: int, max_offset: int) -> int:
    bitlimit = logmn(max(doc_len, max_offset)) + 1
    ite = 3 + 3 * bitlimit
    return (1 + bitlimit * (2 * batch_size + 1) + bitlimit * 3 * batch_size
            + bitlimit * 2 * batch_size + bitlimit * (batch_size + 1) + ite)


def stack_circuit_cost(n_states: int, doc_len: int, max_branches: int,
                       max_stack: int) -> int:
    log_states = logmn(n_states)
    bitlimit = logmn(doc_len) + 1
    push = 7 + max_branches * (3 + 2 * log_states + max_stack * 14) + log_states
    pop = 4 + max_stack * 7 + 4 * bitlimit
    return push + pop + 27 + 3 + 14


def full_round_cost_model(num_states: int, num_edges: int, batch_size: int,
                          doc_len: int, hybrid: bool, hybrid_len,
                          project: bool, max_offset: int, max_branches: int,
                          max_stack: int, num_chars: int = 1 << 8) -> int:
    dlen_pow2 = next_power_of_two(doc_len)
    safa_pow2 = next_power_of_two(num_edges)
    lookup_cost = lookup_idxs_cost(num_states, batch_size, num_chars)
    if hybrid:
        total = nl_doc(batch_size * 2, hybrid_len, hybrid, project) + lookup_cost
    else:
        total = (nl(batch_size, safa_pow2, False) + lookup_cost
                 + nl_doc(batch_size, dlen_pow2, hybrid, project))
    total += cursor_circuit_cost(dlen_pow2, batch_size, max_offset)
    total += stack_circuit_cost(num_states, dlen_pow2, max_branches, max_stack)
    return total


def get_folded_cost(cost: int, solution_lens, batch_size: int) -> int:
    n_folding = sum(math.ceil(x / batch_size) for x in solution_lens)
    # per-fold prover work tracks the COMMIT domains, which pad to powers
    # of two: crossing a boundary doubles the W/T MSMs, so round here to
    # keep the model from drifting into a domain jump for a marginal
    # batch-size gain
    per_fold = next_power_of_two(V1 + cost) + next_power_of_two(V2)
    return 2 * n_folding * per_fold + 8 * next_power_of_two(V1 + cost)


def opt_cost_model_select(num_states: int, num_edges: int, doc_len: int,
                          hybrid: bool, hybrid_len, project: bool,
                          max_offset: int, max_branches: int, max_stack: int,
                          solution_lens, num_chars: int = 1 << 8) -> int:
    """Minimize folded cost over batch sizes 2..sum(paths) (costs.rs:207-244).

    Batch size 1 is excluded: the reference asserts batch > 1 (r1cs.rs:515).
    """
    best_batch, best_cost = 2, None
    # cap the search: beyond ~512 the step circuit dwarfs every fold
    # saving, and trace estimates can reach the full doc length
    max_fold = min(max(2, sum(solution_lens)), 512)
    for n in range(2, max_fold + 1):
        c = full_round_cost_model(num_states, num_edges, n, doc_len, hybrid,
                                  hybrid_len, project, max_offset,
                                  max_branches, max_stack, num_chars)
        fc = get_folded_cost(c, solution_lens, n)
        if best_cost is None or fc < best_cost:
            best_cost, best_batch = fc, n
    return best_batch
