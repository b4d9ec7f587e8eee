// K6: the tree-node write of the batched MCTS, one warp per game.
//
// Replaces: alphazero_risk_tpu/mcts/search.py, the node value, expansion
// writes and leaf select of `simulate_once` (`term` and `node_value` from
// the child's status and the network's value, then some twenty-five masked
// `.at[].set` scatters over the 14 GameState fields and 8 tree arrays of
// the new node, the child link, `next_free`, and the `where` that picks the
// leaf value and player), and the root writes of `init_tree`.
//
// Per game, when it is expanding (exp_n >= 0 and its root is not terminal):
// node idx = min(next_free, N - 1) receives the child state, expanded,
// terminal = (status != NOT_ENDED), value (the terminal value of the
// status for the child's mover when terminal, else the network's), player,
// parent, legal and prior; children[exp_n, exp_a, exp_o] = idx;
// next_free += 1.  A game that is not expanding writes nothing.  Every game
// emits its leaf value and player: the new node's when expanding, else
// those of the node the descent ended on.  With root_mode the same copies
// go to node 0 for every game, with no parent, link, counter or leaf
// output.
//
// Bound on an H100: latency.  A game's node is about 1 KB, so the whole
// write at B=64 moves under 150 KB, far below a microsecond of memory time;
// what a game waits on is its chain of loads.  The design:
//
//   - one warp per game, four games per block;
//   - every load that depends only on the game issues at once: exp_n,
//     exp_a, exp_o, cur, root, next_free, the child's status, raw value
//     and mover, and the source rows; then the second round,
//     terminal[root], value[cur] and player[cur];
//   - the two 42-int rows (168 bytes, 8-byte aligned) go as 21 8-byte
//     words, the other rows by lanes (one element each, coalesced), and
//     each scalar field (the two card counts too) by a lane of its own;
//   - a __syncwarp between the reads of nodes root and cur and the writes
//     of node idx, which may be either of them in a full tree.
//
// Pure copies and two selects, so the result equals the plain version bit
// for bit, bool fields (one byte each) included.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;             // games per block
constexpr int kLands = 42;
constexpr int kActions = 43;
constexpr int kWords = kLands / 2;    // 8-byte words of a 42-int row
constexpr int kNotEnded = -1;
constexpr int kDraw = -2;

struct StatePtrs {
  int32_t* owner;           // [.., 42]
  int32_t* army;            // [.., 42]
  int32_t* phase;
  int32_t* round;
  int32_t* cur_player;
  int32_t* reinforcements;
  int32_t* cards;           // [.., 2]
  int32_t* card_sets_played;
  int32_t* mob_from;
  int32_t* mob_to;
  uint8_t* can_draw_card;
  int32_t* attacks_during_turn;
  uint8_t* player_cards;    // [.., 2, 42]
  uint8_t* drawn_cards;     // [.., 42]
};

// The tree's arrays and the leaf outputs: the pointers the host packs
// once per tree, in this order.
struct TreeRef {
  StatePtrs ts;
  uint8_t* expanded;
  uint8_t* terminal;
  float* value;
  int32_t* player;
  int32_t* parent;
  uint8_t* legal;
  float* prior;
  int32_t* children;
  int32_t* next_free;
  const int32_t* root;
  float* leaf_v;
  int32_t* leaf_p;
};

struct SrcRef {
  StatePtrs cs;
  const int32_t* status;
  const float* value;
  const uint8_t* legal;
  const float* probs;
};

struct PathRef {
  const int32_t* exp_n;
  const int32_t* exp_a;
  const int32_t* exp_o;
  const int32_t* cur;
};

// The lane's share of a 42-int row: with `words` (both row starts 8-byte
// aligned, as the tensors' starts make them: rows are 168 bytes) lanes
// 0-20 hold one 8-byte word each, else every lane one or two ints.
struct IntRow {
  uint64_t w;
  int32_t i0, i1;
};

__device__ __forceinline__ IntRow read_ints(const int32_t* src, int lane,
                                            bool words) {
  IntRow r{0, 0, 0};
  if (words) {
    if (lane < kWords) r.w = reinterpret_cast<const uint64_t*>(src)[lane];
  } else {
    r.i0 = src[lane];
    if (lane + 32 < kLands) r.i1 = src[lane + 32];
  }
  return r;
}

__device__ __forceinline__ void write_ints(int32_t* dst, const IntRow& r,
                                           int lane, bool words) {
  if (words) {
    if (lane < kWords) reinterpret_cast<uint64_t*>(dst)[lane] = r.w;
  } else {
    dst[lane] = r.i0;
    if (lane + 32 < kLands) dst[lane + 32] = r.i1;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
write_nodes_kernel(TreeRef t, SrcRef s, PathRef p, int B, int N,
                   int root_mode) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const int64_t base = static_cast<int64_t>(b) * N;
  const StatePtrs& cs = s.cs;
  const StatePtrs& ts = t.ts;

  // ---- first round: every load that depends on the game alone ----
  const int status = s.status[b];
  const float raw = s.value[b];
  const int cp = cs.cur_player[b];
  int en = 0, ea = 0, eo = 0, cu = 0, rt = 0, nf = 0;
  if (!root_mode) {
    en = p.exp_n[b];
    ea = p.exp_a[b];
    eo = p.exp_o[b];
    cu = p.cur[b];
    rt = t.root[b];
    nf = t.next_free[b];
  }
  // the lane's scalar field of the source (lanes 0-10), as its 4 bytes
  int32_t scal = 0;
  switch (lane) {
    case 0: scal = cs.phase[b]; break;
    case 1: scal = cs.round[b]; break;
    case 2: scal = cp; break;
    case 3: scal = cs.reinforcements[b]; break;
    case 4: scal = cs.card_sets_played[b]; break;
    case 5: scal = cs.mob_from[b]; break;
    case 6: scal = cs.mob_to[b]; break;
    case 7: scal = cs.can_draw_card[b]; break;
    case 8: scal = cs.attacks_during_turn[b]; break;
    case 9: case 10: scal = cs.cards[2 * b + lane - 9]; break;
    default: break;
  }
  const bool words =
      ((reinterpret_cast<uintptr_t>(cs.owner) |
        reinterpret_cast<uintptr_t>(cs.army) |
        reinterpret_cast<uintptr_t>(ts.owner) |
        reinterpret_cast<uintptr_t>(ts.army)) & 7) == 0;
  const IntRow owner =
      read_ints(cs.owner + static_cast<int64_t>(b) * kLands, lane, words);
  const IntRow army =
      read_ints(cs.army + static_cast<int64_t>(b) * kLands, lane, words);
  const int pc = 2 * kLands;
  uint8_t pcards[3], drawn[2], legal[2];
  float prior[2];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    pcards[k] = lane + 32 * k < pc ? cs.player_cards[b * pc + lane + 32 * k]
                                   : 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool in_l = lane + 32 * k < kLands, in_a = lane + 32 * k < kActions;
    drawn[k] = in_l ? cs.drawn_cards[b * kLands + lane + 32 * k] : 0;
    legal[k] = in_a ? s.legal[b * kActions + lane + 32 * k] : 0;
    prior[k] = in_a ? s.probs[b * kActions + lane + 32 * k] : 0.f;
  }

  // term and node value (search.py _terminal_value)
  const bool term = status != kNotEnded;
  const float node_value =
      term ? (status == kDraw ? 0.0f : (status == cp ? 1.0f : -1.0f)) : raw;

  int idx = 0;
  if (!root_mode) {
    // ---- second round: the nodes the first round names ----
    const bool root_done = t.terminal[base + rt] != 0;
    const float v_cur = t.value[base + cu];
    const int p_cur = t.player[base + cu];
    const bool expanding = en >= 0 && !root_done;
    idx = expanding ? nf : 0;
    idx = idx < N - 1 ? idx : N - 1;
    if (lane == 0) {
      t.leaf_v[b] = expanding ? node_value : v_cur;
      t.leaf_p[b] = expanding ? cp : p_cur;
    }
    // every lane has read nodes root and cur before any lane writes node
    // idx, which a full tree may share with them
    __syncwarp();
    if (!expanding) return;
  }

  // ---- the writes of node idx ----
  const int64_t d = base + idx;
  write_ints(ts.owner + d * kLands, owner, lane, words);
  write_ints(ts.army + d * kLands, army, lane, words);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (lane + 32 * k < pc) ts.player_cards[d * pc + lane + 32 * k] = pcards[k];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (lane + 32 * k < kLands)
      ts.drawn_cards[d * kLands + lane + 32 * k] = drawn[k];
    if (lane + 32 * k < kActions) {
      t.legal[d * kActions + lane + 32 * k] = legal[k];
      t.prior[d * kActions + lane + 32 * k] = prior[k];
    }
  }
  switch (lane) {
    case 0: ts.phase[d] = scal; break;
    case 1: ts.round[d] = scal; break;
    case 2: ts.cur_player[d] = scal; break;
    case 3: ts.reinforcements[d] = scal; break;
    case 4: ts.card_sets_played[d] = scal; break;
    case 5: ts.mob_from[d] = scal; break;
    case 6: ts.mob_to[d] = scal; break;
    case 7: ts.can_draw_card[d] = static_cast<uint8_t>(scal); break;
    case 8: ts.attacks_during_turn[d] = scal; break;
    case 9: case 10: ts.cards[2 * d + lane - 9] = scal; break;
    case 11: t.expanded[d] = 1; break;
    case 12: t.terminal[d] = term ? 1 : 0; break;
    case 13: t.value[d] = node_value; break;
    case 14: t.player[d] = cp; break;
    case 15:
      if (!root_mode) t.parent[d] = en;
      break;
    case 16:
      if (!root_mode)
        t.children[((base + en) * kActions + ea) * 3 + eo] = idx;
      break;
    case 17:
      if (!root_mode) t.next_free[b] = nf + 1;
      break;
    default: break;
  }
}

int32_t* i32(void* q) { return static_cast<int32_t*>(q); }
uint8_t* u8(void* q) { return static_cast<uint8_t*>(q); }
float* f32(void* q) { return static_cast<float*>(q); }

StatePtrs state_ptrs(void* const* f) {
  return StatePtrs{i32(f[0]), i32(f[1]), i32(f[2]),  i32(f[3]),  i32(f[4]),
                   i32(f[5]), i32(f[6]), i32(f[7]),  i32(f[8]),  i32(f[9]),
                   u8(f[10]), i32(f[11]), u8(f[12]), u8(f[13])};
}

}  // namespace

// tree: a host array of 26 pointers, packed once per tree: the 14
// GameState fields of the tree, [B, N, ...]; the tree arrays expanded,
// terminal [B, N] bool, value f32, player, parent i32 [B, N], legal bool
// and prior f32 [B, N, 43], children i32 [B, N, 43, 3], next_free and root
// i32 [B]; the leaf outputs leaf_v f32 and leaf_p i32 [B].  c0..c13: the 14
// fields of the source states, [B, ...]; status i32 and value f32 [B]
// (the network's, before the terminal select); legal_c bool and probs_c
// f32 [B, 43].  exp_n, exp_a, exp_o, cur i32 [B] may be null with
// root_mode.  State fields come in the order of the dataclass: owner,
// army, phase, round, cur_player, reinforcements, cards, card_sets_played,
// mob_from, mob_to, can_draw_card, attacks_during_turn, player_cards,
// drawn_cards.  Launches on `stream` and returns cudaGetLastError().
extern "C" int az_write_nodes(
    void* const* tree, void* c0, void* c1, void* c2, void* c3, void* c4,
    void* c5, void* c6, void* c7, void* c8, void* c9, void* c10, void* c11,
    void* c12, void* c13, const void* status, const void* value,
    const void* legal_c, const void* probs_c, const void* exp_n,
    const void* exp_a, const void* exp_o, const void* cur, int B, int N,
    int root_mode, void* stream) {
  const TreeRef t{state_ptrs(tree), u8(tree[14]),  u8(tree[15]),
                  f32(tree[16]),    i32(tree[17]), i32(tree[18]),
                  u8(tree[19]),     f32(tree[20]), i32(tree[21]),
                  i32(tree[22]),    i32(tree[23]), f32(tree[24]),
                  i32(tree[25])};
  void* const src[14] = {c0, c1, c2, c3, c4, c5, c6,
                         c7, c8, c9, c10, c11, c12, c13};
  const SrcRef s{state_ptrs(src), static_cast<const int32_t*>(status),
                 static_cast<const float*>(value),
                 static_cast<const uint8_t*>(legal_c),
                 static_cast<const float*>(probs_c)};
  const PathRef p{static_cast<const int32_t*>(exp_n),
                  static_cast<const int32_t*>(exp_a),
                  static_cast<const int32_t*>(exp_o),
                  static_cast<const int32_t*>(cur)};
  write_nodes_kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(t, s, p, B, N,
                                                            root_mode);
  return static_cast<int>(cudaGetLastError());
}
