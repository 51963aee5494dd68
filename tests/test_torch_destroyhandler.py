"""The destroy handler (``aesara_tpu_torch/graph/destroyhandler.py``)
against the JAX package's: the cases of
``tests/graph/test_destroyhandler_corpus.py`` (view chains and ``droot``,
races between destroyers, protected inputs reached through views,
constants, usage loops, readers ordered before their destroyer,
``fast_inplace_check``, input aliasing and its tolerances), each built in
both packages, give the same decisions: the same error (by kind) or none,
the same roots, destroyers and candidates, and the readers before their
destroyer in ``toposort``.  Then the port's ``donations``, the question
the linker asks of an update's node."""

import pytest

import aesara_tpu.graph.destroyhandler as jdh
import aesara_tpu.graph.features as jfeatures
import aesara_tpu.graph.fg as jfg
import aesara_tpu.graph.ir as jir
import aesara_tpu.graph.op as jop

import aesara_tpu_torch.graph.destroyhandler as pdh
import aesara_tpu_torch.graph.features as pfeatures
import aesara_tpu_torch.graph.fg as pfg
import aesara_tpu_torch.graph.ir as pir
import aesara_tpu_torch.graph.op as pop


class Package:
    """The corpus's toy type and ops built on one package's graph classes."""

    def __init__(self, ir, op, fg, features, dh):
        self.dh, self.ir, self.fg, self.features = dh, ir, fg, features

        class T(ir.Type):
            def filter(self, data, strict=False, allow_downcast=None):
                return data

            def __eq__(self, other):
                return type(self) is type(other)

            def __hash__(self):
                return hash(type(self))

            def __str__(self):
                return "T"

        self.T = T()
        pkg = self

        class Base(op.Op):
            __props__ = ()

            def make_node(self, *inputs):
                return ir.Apply(self, list(inputs), [pkg.V()])

            def perform(self, node, inputs, outputs):
                outputs[0][0] = inputs[0]

            def __str__(self):
                return type(self).__name__

        class Plain(Base):
            pass

        class View(Base):
            view_map = {0: [0]}

        class Destroy(Base):
            destroy_map = {0: [0]}

        class DestroySecond(Base):
            destroy_map = {0: [1]}

        class DestroyTolerant(Base):
            destroy_map = {0: [0]}
            destroyhandler_tolerate_same = [(0, 1)]

        class DestroySiblings(Base):
            destroy_map = {0: [0]}
            destroyhandler_tolerate_aliased = [(0, 1)]

        self.plain, self.view, self.destroy = Plain(), View(), Destroy()
        self.destroy_second, self.tolerant, self.siblings = DestroySecond(), DestroyTolerant(), DestroySiblings()

    def V(self, name=None):
        return self.ir.Variable(self.T, None, None, name=name)

    def const(self, value):
        return self.ir.Constant(self.T, value)

    def make_fg(self, inputs, outputs, protected=()):
        fg = self.fg.FunctionGraph(inputs, outputs, clone=False)
        fg.attach_feature(self.features.ReplaceValidate())
        fg.attach_feature(self.dh.DestroyHandler())
        if protected:
            fg.attach_feature(self.dh.Supervisor(protected))
        return fg


JAX = Package(jir, jop, jfg, jfeatures, jdh)
PORT = Package(pir, pop, pfg, pfeatures, pdh)


def _validate(p, fg):
    """None, or the kind of InconsistencyError ``validate`` raises."""
    try:
        fg.validate()
    except p.dh.InconsistencyError as exc:
        msg = str(exc)
        for kind in ("multiple", "constant", "aliasing", "protected", "cycle"):
            if kind in msg.lower():
                return kind
        return "other"
    return None


def _before(fg, a, b) -> bool:
    topo = fg.toposort()
    return topo.index(a.owner) < topo.index(b.owner)


# each case builds its graph in package p and returns what was decided
def case_droot(p):
    x = p.V("x")
    v2 = p.view(p.view(x))
    d = p.destroy(x)
    return [p.dh.droot(v2) is x, p.dh.droot(v2.owner.inputs[0]) is x, p.dh.droot(x) is x, p.dh.droot(d) is d]


def case_single_destroyer(p):
    x = p.V("x")
    r, d = p.plain(x), p.destroy(x)
    fg = p.make_fg([x], [r, d])
    return [_validate(p, fg), _before(fg, r, d)]


def case_two_destroyers(p):
    x = p.V("x")
    return [_validate(p, p.make_fg([x], [p.destroy(x), p.destroy(x)]))]


def case_two_destroyers_through_views(p):
    x = p.V("x")
    return [_validate(p, p.make_fg([x], [p.destroy(p.view(x)), p.destroy(p.view(x))]))]


def case_view_and_root_race(p):
    x = p.V("x")
    return [_validate(p, p.make_fg([x], [p.destroy(x), p.destroy(p.view(x))]))]


def case_chain_of_destroyers(p):
    x = p.V("x")
    d1 = p.destroy(x)
    d2 = p.destroy(d1)
    fg = p.make_fg([x], [d2])
    return [_validate(p, fg), _before(fg, d1, d2)]


def case_protected_direct(p):
    x = p.V("x")
    return [_validate(p, p.make_fg([x], [p.destroy(x)], protected=[x]))]


def case_protected_through_deep_views(p):
    x = p.V("x")
    return [_validate(p, p.make_fg([x], [p.destroy(p.view(p.view(p.view(x))))], protected=[x]))]


def case_unprotected_view_destroyed(p):
    x = p.V("x")
    return [_validate(p, p.make_fg([x], [p.destroy(p.view(x))]))]


def case_constant_through_view(p):
    x = p.V("x")
    return [_validate(p, p.make_fg([x], [p.plain(x), p.destroy(p.view(p.const(42)))]))]


def case_usage_loop(p):
    x = p.V("x")
    d = p.destroy(x)
    return [_validate(p, p.make_fg([x], [p.destroy_second(x, d)]))]


def case_reader_of_view_before_root_destroyer(p):
    x = p.V("x")
    v = p.view(x)
    r, d = p.plain(v), p.destroy(x)
    fg = p.make_fg([x], [r, d])
    return [_validate(p, fg), _before(fg, v, d), _before(fg, r, d)]


def case_reader_of_root_before_view_destroyer(p):
    x = p.V("x")
    r, d = p.plain(x), p.destroy(p.view(x))
    fg = p.make_fg([x], [r, d])
    return [_validate(p, fg), _before(fg, r, d)]


def case_view_aware_destroyers(p):
    x = p.V("x")
    v = p.view(x)
    d = p.destroy(v)
    fg = p.make_fg([x], [d])
    return [fg.destroyers(x) == [d.owner], fg.destroyers(v) == [d.owner], fg.has_destroyers([x]),
            fg.has_destroyers([d])]


def case_prune_and_revert(p):
    x = p.V("x")
    d1, r = p.destroy(x), p.plain(x)
    fg = p.make_fg([x], [d1, r])
    first = _validate(p, fg)
    try:
        fg.replace_validate(r, p.destroy(x))
        refused = False
    except p.dh.InconsistencyError:
        refused = True
    kept = r in fg.variables
    fg.replace_validate(d1, p.plain(x))
    return [first, refused, kept, fg.destroyers(x), _validate(p, fg)]


def case_second_input_destroyed(p):
    x, y = p.V("x"), p.V("y")
    return [_validate(p, p.make_fg([x, y], [p.destroy_second(x, y)], protected=[y])),
            _validate(p, p.make_fg([x, y], [p.destroy_second(x, y)], protected=[x]))]


def case_fast_inplace_check(p):
    x = p.V("x")
    a = p.plain(x)
    b = p.plain(a)
    fg = p.make_fg([x], [b], protected=[x])
    got = p.dh.fast_inplace_check(fg, [x, a, b])
    return [a in got, x in got, b in got]


def case_input_aliasing(p):
    x, y = p.V("x"), p.V("y")
    v = p.view(x)
    return [_validate(p, p.make_fg([x], [p.destroy_second(x, x)])),
            _validate(p, p.make_fg([x], [p.destroy_second(v, x)])),
            _validate(p, p.make_fg([x], [p.tolerant(x, x)])),
            _validate(p, p.make_fg([x], [p.tolerant(x, p.view(x))])),
            _validate(p, p.make_fg([x], [p.siblings(p.view(x), p.view(x))])),
            _validate(p, p.make_fg([x, y], [p.destroy_second(x, y)]))]


CASES = [case_droot, case_single_destroyer, case_two_destroyers, case_two_destroyers_through_views,
         case_view_and_root_race, case_chain_of_destroyers, case_protected_direct, case_protected_through_deep_views,
         case_unprotected_view_destroyed, case_constant_through_view, case_usage_loop,
         case_reader_of_view_before_root_destroyer, case_reader_of_root_before_view_destroyer,
         case_view_aware_destroyers, case_prune_and_revert, case_second_input_destroyed, case_fast_inplace_check,
         case_input_aliasing]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_the_handler_decides_as_the_jax_packages(case):
    want = case(JAX)
    assert case(PORT) == want
    # the cases do decide something: an error or an ordering somewhere
    assert want


def test_the_corpus_has_refusals_of_every_kind():
    kinds = {r for case in CASES for r in case(PORT) if isinstance(r, str)}
    assert {"multiple", "constant", "aliasing", "protected", "cycle"} <= kinds


# --- donations: the linker's question ------------------------------------------


def test_donations_keep_the_legal_writers_and_order_the_readers_first():
    p = PORT
    w, x = p.V("w"), p.V("x")
    r = p.plain(w)                 # reads the old w
    new = p.plain(r)               # w's new value, computed by a node that does not read w
    for returned in (w, p.view(w)):
        # an output that is the old w, or a view of it, would be overwritten
        fg = p.make_fg([w, x], [returned, new])
        assert fg.destroy_handler.donations(fg, [(new.owner, w, [])])[0] == []
    fg2 = p.make_fg([w, x], [r, new])
    kept, order = fg2.destroy_handler.donations(fg2, [(new.owner, w, [])])
    assert [k[0] for k in kept] == [new.owner] and order[new.owner] == [r.owner]
    assert fg2.toposort().index(r.owner) < fg2.toposort().index(new.owner)


def test_donations_refuse_a_view_read_by_the_writer_and_a_swap():
    p = PORT
    w = p.V("w")
    upd = p.destroy_second(p.view(w), w)        # reads a view of w besides w itself
    fg = p.make_fg([w], [upd])
    assert fg.destroy_handler.donations(fg, [(upd.owner, w, [1])])[0] == []
    a, b = p.V("a"), p.V("b")
    na, nb = p.plain(b), p.plain(a)             # a <- f(b), b <- f(a)
    fg = p.make_fg([a, b], [na, nb])
    kept, _ = fg.destroy_handler.donations(fg, [(na.owner, a, []), (nb.owner, b, [])])
    assert len(kept) == 1                       # each reads the other's old value: one copies


def test_donations_decide_consistent_candidates_in_one_check(monkeypatch):
    """Where every candidate is legal together, ``donations`` keeps them all
    after one check; where they conflict (a swap) it decides one at a time
    and keeps the first, as it would taken in order."""
    p = PORT
    calls = []
    check = pdh.DestroyHandler._check
    monkeypatch.setattr(pdh.DestroyHandler, "_check", lambda self, fg, roots: calls.append(1) or check(self, fg, roots))
    a, b, x = p.V("a"), p.V("b"), p.V("x")
    na, nb = p.plain(x), p.plain(p.plain(x))    # a <- f(x), b <- g(x): independent writers
    fg = p.make_fg([a, b, x], [na, nb])
    calls.clear()
    kept, _ = fg.destroy_handler.donations(fg, [(na.owner, a, []), (nb.owner, b, [])])
    assert [k[0] for k in kept] == [na.owner, nb.owner] and len(calls) == 1
    sa, sb = p.plain(b), p.plain(a)             # a <- f(b), b <- f(a)
    fg = p.make_fg([a, b], [sa, sb])
    calls.clear()
    kept, _ = fg.destroy_handler.donations(fg, [(sa.owner, a, []), (sb.owner, b, [])])
    assert [k[0] for k in kept] == [sa.owner] and len(calls) == 3
