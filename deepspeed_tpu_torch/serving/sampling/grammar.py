"""Grammar-constrained decoding: host-compiled DFA -> per-step token
bitmask — the port's own copy of
``deepspeed_tpu/serving/sampling/grammar.py`` (numpy and ``json``).

Pipeline: a JSON-schema (restricted subset) or a regex compiles ONCE on
the host to a character-level DFA (Thompson NFA -> subset
construction).  A :class:`TokenDFA` lifts the DFA to token level
against a vocabulary (token id -> string): for each DFA state it lazily
computes an allowed-token bitmask plus the state each token transitions
to, caching rows per state.  A :class:`GrammarConstraint` is the
per-request cursor the scheduler owns — it hands the dispatch its
current mask row (staged into the device grammar-mask table) and
advances on each harvested token.

Replay contract: the constraint is *derivable from the emitted tokens
alone* — on preemption-recompute or replica failover a fresh
constraint is advanced over the already-served output suffix and lands
in the identical DFA state, so constrained generation survives every
resilience path with 100% schema-valid output (the grammar oracle pins
this end-to-end).

EOS handling: the eos token is allowed iff the current state is
accepting; all other tokens follow the DFA.  A request without an eos
id finishes when the DFA is *exhausted* (accepting with no outgoing
token edges) — the scheduler checks ``done`` after each advance.

The regex dialect: literals, ``.``, classes ``[a-z0-9_]`` /
``[^...]``, escapes (``\\d \\w \\s \\n \\t`` + punctuation), grouping
``(...)``, alternation ``|``, repetition ``* + ?`` and bounded
``{m,n}`` (expanded, n <= 64).  Anchored implicitly: the whole output
must match.
"""

import json

import numpy as np

_MAX_BOUNDED_REPEAT = 64
_ALPHABET = 256  # byte-level; vocab strings index chars mod 256

_DIGITS = frozenset("0123456789")
_WORD = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = frozenset(" \t\n\r\f\v")


# --------------------------------------------------------------- regex


class RegexError(ValueError):
    pass


class _Parser:
    """Recursive-descent regex -> AST.

    AST nodes: ("char", frozenset_of_chars) | ("cat", [nodes]) |
    ("alt", [nodes]) | ("star", node) | ("empty",)
    """

    def __init__(self, pattern):
        self.p = pattern
        self.i = 0

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise RegexError(f"unexpected {self.p[self.i]!r} at "
                             f"{self.i} in {self.p!r}")
        return node

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def _alt(self):
        branches = [self._cat()]
        while self._peek() == "|":
            self.i += 1
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        parts = []
        while self._peek() not in (None, "|", ")"):
            parts.append(self._repeat())
        if not parts:
            return ("empty",)
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def _repeat(self):
        node = self._atom()
        c = self._peek()
        if c == "*":
            self.i += 1
            return ("star", node)
        if c == "+":
            self.i += 1
            return ("cat", [node, ("star", node)])
        if c == "?":
            self.i += 1
            return ("alt", [node, ("empty",)])
        if c == "{":
            return self._bounded(node)
        return node

    def _bounded(self, node):
        j = self.p.index("}", self.i)
        spec = self.p[self.i + 1:j]
        self.i = j + 1
        if "," in spec:
            lo_s, hi_s = spec.split(",", 1)
            lo = int(lo_s or 0)
            hi = int(hi_s) if hi_s else None
        else:
            lo = hi = int(spec)
        if hi is not None and (hi < lo or hi > _MAX_BOUNDED_REPEAT):
            raise RegexError(f"bad bound {{{spec}}} (max "
                             f"{_MAX_BOUNDED_REPEAT})")
        parts = [node] * lo
        if hi is None:
            parts.append(("star", node))
        else:
            parts.extend([("alt", [node, ("empty",)])] * (hi - lo))
        if not parts:
            return ("empty",)
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def _atom(self):
        c = self._peek()
        if c is None:
            raise RegexError("unexpected end of pattern")
        if c == "(":
            self.i += 1
            node = self._alt()
            if self._peek() != ")":
                raise RegexError("unbalanced '('")
            self.i += 1
            return node
        if c == "[":
            return ("char", self._char_class())
        if c == ".":
            self.i += 1
            return ("char", frozenset(chr(b) for b in range(_ALPHABET)
                                      if chr(b) != "\n"))
        if c == "\\":
            self.i += 1
            return ("char", self._escape())
        if c in "*+?{":
            raise RegexError(f"dangling {c!r} at {self.i}")
        self.i += 1
        return ("char", frozenset(c))

    def _escape(self):
        c = self._peek()
        if c is None:
            raise RegexError("dangling backslash")
        self.i += 1
        table = {"d": _DIGITS, "w": _WORD, "s": _SPACE,
                 "n": frozenset("\n"), "t": frozenset("\t"),
                 "r": frozenset("\r")}
        if c in table:
            return table[c]
        if c in "DWS":
            base = {"D": _DIGITS, "W": _WORD, "S": _SPACE}[c]
            return frozenset(chr(b) for b in range(_ALPHABET)
                             if chr(b) not in base)
        return frozenset(c)  # escaped literal/punctuation

    def _char_class(self):
        assert self.p[self.i] == "["
        self.i += 1
        negate = self._peek() == "^"
        if negate:
            self.i += 1
        chars = set()
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise RegexError("unbalanced '['")
            if c == "]" and not first:
                self.i += 1
                break
            first = False
            if c == "\\":
                self.i += 1
                chars |= self._escape()
                continue
            self.i += 1
            if self._peek() == "-" and self.i + 1 < len(self.p) and \
                    self.p[self.i + 1] != "]":
                hi = self.p[self.i + 1]
                self.i += 2
                chars |= {chr(b) for b in range(ord(c), ord(hi) + 1)}
            else:
                chars.add(c)
        if negate:
            chars = {chr(b) for b in range(_ALPHABET)} - chars
        return frozenset(chars)


# ------------------------------------------------------- NFA -> DFA

_MAX_DFA_STATES = 50_000


def _charmask(chars):
    """frozenset of chars -> 256-bit int bitmask."""
    m = 0
    for c in chars:
        b = ord(c)
        if b < _ALPHABET:
            m |= 1 << b
    return m


def _nfa(node, nfa, start):
    """Thompson construction; returns the accept state id.  ``nfa`` is
    (eps: list[set[int]], edges: list[list[(charmask_int, int)]])."""
    eps, edges = nfa

    def new_state():
        eps.append(set())
        edges.append([])
        return len(eps) - 1

    kind = node[0]
    if kind == "empty":
        return start
    if kind == "char":
        acc = new_state()
        edges[start].append((_charmask(node[1]), acc))
        return acc
    if kind == "cat":
        cur = start
        for part in node[1]:
            cur = _nfa(part, nfa, cur)
        return cur
    if kind == "alt":
        acc = new_state()
        for branch in node[1]:
            b_start = new_state()
            eps[start].add(b_start)
            eps[_nfa(branch, nfa, b_start)].add(acc)
        return acc
    if kind == "star":
        hub = new_state()
        eps[start].add(hub)
        body_start = new_state()
        eps[hub].add(body_start)
        eps[_nfa(node[1], nfa, body_start)].add(hub)
        return hub
    raise RegexError(f"unknown node {kind}")


def _atoms(masks):
    """Partition the 256-char alphabet into equivalence classes under
    the NFA's edge charsets — subset construction then iterates atoms
    (a handful) instead of 256 chars per state."""
    full = (1 << _ALPHABET) - 1
    parts = [full]
    for m in set(masks):
        nxt = []
        for p in parts:
            a, b = p & m, p & ~m
            if a:
                nxt.append(a)
            if b:
                nxt.append(b)
        parts = nxt
    return parts


class CharDFA:
    """Deterministic char-level automaton.

    ``trans``: list (per state) of dict char -> next state id.
    ``accepting``: set of state ids.  State 0 is the start.
    """

    def __init__(self, pattern):
        self.pattern = pattern
        ast = _Parser(pattern).parse()
        eps, edges = [set()], [[]]
        accept = _nfa(ast, (eps, edges), 0)
        n = len(eps)

        # per-NFA-state epsilon closure, computed once
        closure1 = [None] * n
        for s in range(n):
            if closure1[s] is not None:
                continue
            seen = {s}
            stack = [s]
            while stack:
                x = stack.pop()
                for t in eps[x]:
                    if t not in seen:
                        seen.add(t)
                        stack.append(t)
            closure1[s] = frozenset(seen)

        atoms = _atoms([m for es in edges for m, _ in es])
        # one representative byte per atom (lowest set bit)
        reps = [(a & -a).bit_length() - 1 for a in atoms]
        atom_chars = [[chr(b) for b in range(_ALPHABET) if (a >> b) & 1]
                      for a in atoms]

        def close(states):
            out = set()
            for s in states:
                out |= closure1[s]
            return frozenset(out)

        start = close({0})
        subsets = {start: 0}
        self.trans = [{}]
        worklist = [start]
        closure_cache = {}
        while worklist:
            subset = worklist.pop()
            sid = subsets[subset]
            out_edges = [e for s in subset for e in edges[s]]
            if not out_edges:
                continue
            for atom, rep, chars in zip(atoms, reps, atom_chars):
                tgts = frozenset(t for m, t in out_edges
                                 if (m >> rep) & 1)
                if not tgts:
                    continue
                nxt = closure_cache.get(tgts)
                if nxt is None:
                    nxt = closure_cache[tgts] = close(tgts)
                nid = subsets.get(nxt)
                if nid is None:
                    nid = subsets[nxt] = len(self.trans)
                    if nid >= _MAX_DFA_STATES:
                        raise RegexError(
                            f"grammar too large: > {_MAX_DFA_STATES} "
                            f"DFA states for {pattern[:80]!r}...")
                    self.trans.append({})
                    worklist.append(nxt)
                row = self.trans[sid]
                for c in chars:
                    row[c] = nid
        self.accepting = {sid for subset, sid in subsets.items()
                          if accept in subset}

    def step(self, state, char):
        """-> next state id, or None (dead)."""
        return self.trans[state].get(char)

    def matches(self, text):
        state = 0
        for c in text:
            state = self.step(state, c)
            if state is None:
                return False
        return state in self.accepting


# ---------------------------------------------------- token lifting


def byte_vocab(vocab_size):
    """The default token -> string map when no tokenizer text is
    available: token id i is the single char ``chr(i % 256)``.  Many
    ids alias one char — harmless for masking (all aliases get the
    same edge) and it keeps the oracle/bench decodable."""
    return [chr(i % _ALPHABET) for i in range(vocab_size)]


class TokenDFA:
    """Char DFA lifted to a token vocabulary, rows cached per state."""

    def __init__(self, pattern, vocab):
        self.dfa = CharDFA(pattern) if isinstance(pattern, str) \
            else pattern
        self.vocab = list(vocab)
        self.vocab_size = len(self.vocab)
        self._rows = {}  # state -> (mask bool[V], next int32[V])

    def row(self, state):
        cached = self._rows.get(state)
        if cached is not None:
            return cached
        mask = np.zeros(self.vocab_size, dtype=bool)
        nxt = np.full(self.vocab_size, -1, dtype=np.int32)
        for tid, text in enumerate(self.vocab):
            if not text:
                continue  # empty token would stall the DFA forever
            cur = state
            for c in text:
                cur = self.dfa.step(cur, c)
                if cur is None:
                    break
            if cur is not None:
                mask[tid] = True
                nxt[tid] = cur
        mask.setflags(write=False)
        nxt.setflags(write=False)
        self._rows[state] = (mask, nxt)
        return mask, nxt

    def is_accepting(self, state):
        return state in self.dfa.accepting


class GrammarConstraintError(ValueError):
    pass


class GrammarConstraint:
    """Per-request DFA cursor.  NOT shared between requests; the
    TokenDFA (row cache) IS shared across requests with the same spec
    via :func:`compile_grammar`'s caller-side reuse."""

    def __init__(self, token_dfa, eos_token_id=None, spec=None):
        self.tdfa = token_dfa
        self.eos_token_id = eos_token_id
        self.spec = spec  # wire dict, for journal snapshot/replay
        self.state = 0
        self.finished = False

    # ------------------------------------------------------- masking
    def token_mask(self):
        """bool[V] allowed-token mask for the CURRENT state.  The eos
        lane is overridden: allowed iff accepting (eos *ends* the
        match; its vocab text never walks the DFA)."""
        mask, _ = self.tdfa.row(self.state)
        eos = self.eos_token_id
        if eos is not None and 0 <= eos < self.tdfa.vocab_size:
            mask = mask.copy()
            mask[eos] = self.tdfa.is_accepting(self.state)
            mask.setflags(write=False)
        return mask

    @property
    def accepting(self):
        return self.tdfa.is_accepting(self.state)

    @property
    def dead(self):
        """No token (incl. eos) can be emitted from here — admission /
        harvest must fail the request rather than dispatch a row whose
        softmax would be all -inf."""
        return not self.finished and not bool(self.token_mask().any())

    @property
    def done(self):
        """Generation must stop: eos consumed, or the DFA is exhausted
        (accepting, and no token continues the match)."""
        if self.finished:
            return True
        mask, _ = self.tdfa.row(self.state)
        return self.accepting and not bool(mask.any())

    # ------------------------------------------------------ advancing
    def advance(self, token_id):
        if self.finished:
            raise GrammarConstraintError("advance past eos")
        if token_id == self.eos_token_id:
            if not self.accepting:
                raise GrammarConstraintError(
                    "eos emitted in non-accepting state")
            self.finished = True
            return
        mask, nxt = self.tdfa.row(self.state)
        if not (0 <= token_id < self.tdfa.vocab_size) or \
                not mask[token_id]:
            raise GrammarConstraintError(
                f"token {token_id} not allowed in state {self.state}")
        self.state = int(nxt[token_id])

    def replay(self, token_ids):
        """Advance over an already-served output suffix (preemption
        recompute / failover re-admission).  Raises if the suffix is
        not grammar-valid — which would mean the resilience path
        corrupted constrained output, exactly what the oracle hunts."""
        for t in token_ids:
            self.advance(int(t))
        return self

    def fresh(self):
        """A new cursor at the start state, sharing the row cache."""
        return GrammarConstraint(self.tdfa, self.eos_token_id, self.spec)

    # -------------------------------------------------------- oracle
    def accepts(self, token_ids):
        """Offline validity check: does this token sequence (optionally
        ending in eos) land in an accepting state?"""
        cur = self.fresh()
        try:
            for t in token_ids:
                cur.advance(int(t))
        except GrammarConstraintError:
            return False
        return cur.finished or cur.accepting


# ------------------------------------------------ JSON-schema subset


def _escape_literal(text):
    return "".join("\\" + c if c in r"\.[]{}()*+?|^$" else c
                   for c in text)


def json_schema_to_regex(schema, depth=0):
    """Restricted JSON-schema subset -> regex over COMPACT JSON (no
    whitespace, object keys in declaration order, all properties
    required).  Supported: string (free/bounded or enum), integer,
    number, boolean, null, enum, const, array (bounded items), object
    (fixed properties).  Free-form strings are restricted to
    ``[a-zA-Z0-9_ .-]{0,24}`` — the mask must enumerate the charset."""
    if depth > 6:
        raise GrammarConstraintError("schema nesting too deep (> 6)")
    if "const" in schema:
        return _escape_literal(json.dumps(schema["const"],
                                          separators=(",", ":")))
    if "enum" in schema:
        opts = [_escape_literal(json.dumps(v, separators=(",", ":")))
                for v in schema["enum"]]
        return "(" + "|".join(opts) + ")"
    t = schema.get("type")
    if t == "string":
        max_len = min(int(schema.get("maxLength", 24)), 48)
        min_len = int(schema.get("minLength", 0))
        return ('"[a-zA-Z0-9_ .\\-]{%d,%d}"' % (min_len, max_len))
    if t == "integer":
        return "(-?(0|[1-9][0-9]{0,8}))"
    if t == "number":
        return "(-?(0|[1-9][0-9]{0,8})(\\.[0-9]{1,6})?)"
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "array":
        item = json_schema_to_regex(schema.get("items", {"type": "null"}),
                                    depth + 1)
        max_items = min(int(schema.get("maxItems", 4)), 8)
        min_items = int(schema.get("minItems", 0))
        if max_items == 0:
            return "\\[\\]"
        body = f"{item}(,{item}){{{max(min_items - 1, 0)},{max_items - 1}}}"
        if min_items == 0:
            return f"\\[({body})?\\]"
        return f"\\[{body}\\]"
    if t == "object":
        props = schema.get("properties", {})
        if not props:
            return "\\{\\}"
        parts = []
        for key, sub in props.items():
            parts.append('"%s":%s' % (
                _escape_literal(key),
                json_schema_to_regex(sub, depth + 1)))
        return "\\{" + ",".join(parts) + "\\}"
    raise GrammarConstraintError(f"unsupported schema: {schema!r}")


def json_value_regex(depth=2):
    """Schema-free JSON value (``--response-format json_object``),
    bounded nesting.  depth 0 = scalars only."""
    scalar = ('(-?(0|[1-9][0-9]{0,6})|true|false|null|'
              '"[a-zA-Z0-9_ .\\-]{0,24}")')
    val = scalar
    for _ in range(depth):
        arr = f"\\[({val}(,{val}){{0,4}})?\\]"
        obj = f'\\{{("[a-zA-Z0-9_]{{1,12}}":{val}(,"[a-zA-Z0-9_]{{1,12}}":{val}){{0,4}})?\\}}'
        val = f"({scalar}|{arr}|{obj})"
    return val


# ----------------------------------------------------------- facade


def compile_grammar(spec, vocab, eos_token_id=None):
    """``spec`` is the wire dict a request/journal carries:

    * ``{"regex": "..."}``
    * ``{"json_schema": {...}}``
    * ``{"response_format": "json_object"}``

    ``vocab`` is token id -> string (or an int vocab size, which uses
    the byte vocab).  Returns a fresh :class:`GrammarConstraint`.
    """
    if isinstance(vocab, int):
        vocab = byte_vocab(vocab)
    if "regex" in spec:
        pattern = spec["regex"]
    elif "json_schema" in spec:
        pattern = json_schema_to_regex(spec["json_schema"])
    elif spec.get("response_format") == "json_object":
        pattern = json_value_regex()
    else:
        raise GrammarConstraintError(
            f"grammar spec needs 'regex', 'json_schema' or "
            f"'response_format': {spec!r}")
    tdfa = TokenDFA(pattern, vocab)
    return GrammarConstraint(tdfa, eos_token_id=eos_token_id, spec=dict(spec))
