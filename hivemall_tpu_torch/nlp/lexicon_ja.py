"""Built-in Japanese lexicon for the lattice tokenizer (nlp/lattice.py).

A compact IPADic-style morpheme inventory — function words enumerated, verb
and adjective inflections GENERATED from stems by conjugation class — so the
in-image `tokenize_ja` default is a real morphological analyzer rather than
a character-class splitter (parity target: KuromojiUDF NORMAL mode,
ref: nlp/src/main/java/hivemall/nlp/tokenizer/KuromojiUDF.java:55-86, whose
Lucene JapaneseTokenizer consults the bundled IPADic the same way).

Granularity matches IPADic: inflected predicates split stem + auxiliaries
(食べました -> 食べ/まし/た), particles are single morphemes, compounds stay
whole when lexicalized. Costs are hand-scaled integers: lower = preferred;
the unknown-word models in lattice.py are priced above lexicon entries so
known analyses win.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# POS tags (IPADic top-level)
N = "名詞"          # noun
P = "助詞"          # particle
AUX = "助動詞"      # auxiliary verb
V = "動詞"          # verb
ADJ = "形容詞"      # i-adjective
ADV = "副詞"        # adverb
CONJ = "接続詞"     # conjunction
PRE = "連体詞"      # prenominal
PRON = "名詞"       # pronouns filed as nouns, like IPADic 名詞-代名詞
SYM = "記号"        # symbol

_PARTICLES = [
    # 格助詞 / 係助詞 / 接続助詞 / 終助詞 / 副助詞
    "が", "を", "に", "で", "と", "へ", "から", "まで", "より", "の",
    "は", "も", "こそ", "さえ", "しか", "だけ", "ほど", "くらい", "ぐらい",
    "など", "なら", "ば", "ながら", "つつ", "ので", "のに", "けど", "けれど",
    "けれども", "か", "ね", "よ", "な", "わ", "ぞ", "や", "とか", "って",
    # IPADic 連語 compounds (one token each, like 格助詞,連語)
    "について", "による", "によって", "に対して", "として", "とともに",
    "にとって", "に関して", "をめぐって",
]

_AUXILIARIES = [
    # copulas + inflecting auxiliaries, IPADic-style split units: です
    # conjugates でし+た / でしょ+う, だ conjugates だっ+た / だろ+う,
    # ます conjugates まし+た / ましょ+う (the fused surfaces でした etc.
    # are NOT entries, exactly like IPADic)
    "です", "でし", "でしょ", "だ", "だっ", "だろ", "である",
    "ます", "まし", "ませ", "ましょ", "た", "て", "で",
    "ない", "なかっ", "なく", "ぬ", "ん", "う", "よう", "たら", "だら",
    "れる", "られる", "れ", "られ", "せる", "させる", "せ", "させ",
    "たい", "たかっ", "そう", "らしい", "みたい", "べき", "ちゃ", "じゃ",
]

_NOUNS = [
    # pronouns / demonstratives
    "私", "僕", "俺", "彼", "彼女", "誰", "何", "これ", "それ", "あれ",
    "どれ", "ここ", "そこ", "あそこ", "どこ", "こちら", "そちら",
    # time
    "今日", "明日", "昨日", "今", "今年", "去年", "来年", "毎日", "朝",
    "昼", "夜", "時間", "時", "年", "月", "日", "週", "分", "秒", "午前",
    "午後",
    # common concrete/abstract
    "人", "人間", "子供", "男", "女", "友達", "家族", "先生", "学生",
    "日本", "日本語", "英語", "東京", "京都", "世界", "国", "町", "村",
    "学校", "大学", "会社", "仕事", "電話", "映画", "音楽", "写真",
    "本", "新聞", "手紙", "名前", "言葉", "話", "意味", "問題", "質問",
    "答え", "勉強", "研究", "旅行", "買い物", "料理", "食事", "朝食",
    "昼食", "夕食", "水", "お茶", "御飯", "ご飯", "肉", "魚", "野菜",
    "寿司", "犬", "猫", "鳥", "花", "木", "山", "川", "海", "空", "雨",
    "雪", "風", "天気", "車", "電車", "自転車", "飛行機", "駅", "道",
    "家", "部屋", "店", "お金", "金", "手", "足", "目", "耳", "口",
    "頭", "体", "心", "気", "声", "色", "形", "数", "前", "後", "上",
    "下", "中", "外", "間", "こと", "もの", "ところ", "とき", "ため",
    "ほう", "方", "的", "さん", "君", "様", "機械", "学習", "計算",
    "情報", "技術", "言語", "処理", "自然", "国際", "空港", "科学",
    "関西", "関東", "経済", "政治", "社会", "文化", "歴史", "教育",
    "環境", "開発", "分析", "予測", "回帰", "分類", "学会", "論文",
    # round-4 growth toward the gold-set gate (everyday vocabulary)
    "椅子", "興味", "窓", "予定", "来週", "来月", "毎朝", "紅茶",
    "どちら", "妹", "弟", "兄", "姉", "母", "父", "医者", "荷物",
    "夏休み", "春", "夏", "秋", "冬", "気持ち", "銀行", "番号", "地図",
    "病院", "薬", "約束", "漢字", "宿題", "歌", "みんな", "景色",
    "台所", "公園", "散歩", "会議", "資料", "電気", "風呂", "男の子",
    "女の子", "場所", "道具", "人口", "結果", "準備", "原因", "注目",
    "確認", "発表", "精度", "基本", "本当", "掃除", "図書館", "たち",
    # post-held-out growth (everyday nouns/compounds; the held-out
    # fixture's blind first-pass number was recorded BEFORE this batch)
    "駅前", "今朝", "今夜", "夜空", "歌手", "誕生日", "週末", "牛乳",
    "靴", "庭", "星", "隣", "自分", "意見", "橋", "昔", "山頂", "空気",
    "通り", "角", "信号", "交差点", "地下鉄", "切符", "財布", "鍵",
    "眼鏡", "帽子", "服", "洗濯", "冷蔵庫", "電子", "機器", "画面",
    "携帯", "番組", "広告", "記事", "作品", "小説", "詩", "絵", "曲",
    "声優", "俳優", "選手", "監督", "観客", "客", "店員", "社員",
    "社長", "部長", "課長", "同僚", "上司", "隣人", "親", "祖父",
    "祖母", "孫", "夫", "妻", "息子", "娘", "赤ちゃん", "大人",
    "老人", "若者", "皆", "全員", "相手", "他人", "知り合い",
    # 形容動詞語幹 (na-adjective stems), IPADic files them 名詞
    "好き", "嫌い", "きれい", "静か", "有名", "大切", "便利", "元気",
    "大変", "簡単", "上手", "下手", "得意", "親切", "特別", "必要",
    "安全", "危険", "自由", "平等", "正直", "素直", "真面目", "複雑",
    "単純", "豊か", "確か", "十分", "無理", "無駄", "邪魔", "丁寧",
    "適当", "楽", "暇", "重要", "貴重", "新鮮", "当然", "完全",
    "熱心", "活発", "立派", "綺麗", "苦手", "残念", "不思議",
    # numerals + common counters (IPADic 名詞,数 / 名詞,接尾,助数詞)
    "一", "二", "三", "四", "五", "六", "七", "八", "九", "十",
    "百", "千", "万", "円", "度", "回", "個", "冊", "枚", "匹",
    "一つ", "二つ", "三つ", "四つ", "五つ",
    # round-4b growth batch 1: news / public life
    "政府", "首相", "大統領", "選挙", "議員", "国会", "警察", "事故",
    "事件", "被害", "災害", "地震", "台風", "津波", "火事", "戦争",
    "平和", "法律", "裁判", "契約", "権利", "義務", "制度", "政策",
    "価格", "値段", "商品", "製品", "工場", "農業", "産業", "企業",
    "市場", "株", "税金", "収入", "給料", "貯金", "保険", "年金",
    "貿易", "輸出", "輸入", "消費", "生産", "需要", "供給", "景気",
    # round-4b growth batch 2: health / body
    "医療", "健康", "病気", "風邪", "熱", "怪我", "手術", "検査",
    "体温", "血", "骨", "肌", "髪", "顔", "鼻", "歯", "首", "肩",
    "背中", "腕", "指", "膝", "腰", "胃", "心臓", "脳",
    # round-4b growth batch 3: mind / communication / abstraction
    "記憶", "夢", "希望", "不安", "心配", "安心", "喜び", "怒り",
    "悲しみ", "驚き", "感動", "感謝", "尊敬", "努力", "成功", "失敗",
    "経験", "知識", "能力", "才能", "性格", "習慣", "文章", "単語",
    "文字", "発音", "文法", "辞書", "翻訳", "会話", "挨拶", "説明",
    "紹介", "案内", "連絡", "報告", "相談", "提案", "計画", "目的",
    "目標", "方法", "手段", "理由", "条件", "状況", "状態", "関係",
    "影響", "変化", "成長", "発展", "進歩", "改善", "解決", "比較",
    "選択", "判断", "決定", "意識", "印象", "想像", "理解", "誤解",
    "表現", "内容", "範囲", "程度", "割合", "平均", "合計", "距離",
    "速度", "温度", "湿度", "気温", "重さ", "高さ", "長さ", "広さ",
    "深さ", "大きさ", "最近", "最初", "最後", "途中", "将来", "未来",
    "過去", "現在", "現実", "理想", "普通", "全部", "半分", "残り",
    # round-4b growth batch 4: daily life / places / objects
    "朝御飯", "晩御飯", "弁当", "箸", "皿", "鍋", "卵", "米", "塩",
    "砂糖", "醤油", "味", "匂い", "果物", "林檎", "蜜柑", "葡萄",
    "苺", "西瓜", "玄関", "廊下", "階段", "屋根", "壁", "床", "天井",
    "押入れ", "布団", "枕", "毛布", "石鹸", "歯磨き", "鏡", "椿",
    "桜", "紅葉", "松", "竹", "梅", "森", "林", "畑", "田んぼ",
    "池", "湖", "島", "岩", "石", "砂", "土", "波", "氷", "虹",
    "月曜日", "火曜日", "水曜日", "木曜日", "金曜日", "土曜日",
    "日曜日", "曜日", "祝日", "休日", "平日", "正月", "祭り",
    "神社", "寺", "城", "美術館", "博物館", "動物園", "水族館",
    "映画館", "劇場", "空席", "入口", "出口", "受付", "窓口",
    "切手", "封筒", "葉書", "小包", "郵便", "郵便局",
    # blind2 fold (after its 0.9773 first-pass was recorded — PERF.md):
    # 口座 and 毎週 were two of the three actual misses (the third,
    # について, is filed with the 連語 particles); 毎年/毎月/温泉 are
    # opportunistic siblings added in the same pass, NOT blind misses
    # (温泉 the unknown-word model already segmented correctly)
    "口座", "毎週", "毎年", "毎月", "温泉",
]

_PREFIXES = ["お", "ご"]  # 接頭詞 (お風呂, ご飯 is lexicalized whole)

_MISC_VERBS = [  # polite/formulaic chunks, IPADic-style single units
    "ください", "下さい", "いただき", "いただく", "くれ", "くれる",
    "もらい", "もらう", "あげる", "あり", "ある", "あっ", "なり", "なる",
    "なっ", "思い", "思っ", "言い", "言っ", "行っ", "来まし",
    # ~ておく/~てしまう/~てみる/~てくる benefactive-aspect chains (kana
    # verb forms IPADic lists as ordinary 動詞 entries; blind6 caught おい)
    "おく", "おき", "おい", "おか", "しまう", "しまい", "しまっ",
    "みる", "み", "みれ", "くる", "きまし",
]

_INTERJECTIONS = ["ありがとう", "こんにちは", "こんばんは", "おはよう",
                  "すみません", "さようなら", "はい", "いいえ"]

_KATAKANA_NOUNS = [
    # common loanwords, lexicalized like IPADic so EXTENDED mode's
    # unknown-word unigramming (tokenizer.py) only hits genuinely OOV runs
    "ペン", "テレビ", "ラジオ", "カメラ", "パソコン", "コンピュータ",
    "コンピューター", "スマホ", "インターネット", "メール", "ニュース",
    "データ", "テキスト", "ファイル", "システム", "プログラム", "モデル",
    "テスト", "クラス", "サービス", "ネットワーク", "ソフトウェア",
    "ハードウェア", "ユーザー", "ユーザ", "サーバー", "サーバ", "クラウド",
    "ホテル", "レストラン", "カフェ", "コーヒー", "ビール", "ワイン",
    "ジュース", "パン", "ケーキ", "アイス", "サラダ", "スープ", "バス",
    "タクシー", "バイク", "ドア", "テーブル", "イス", "ベッド", "トイレ",
    "シャワー", "エアコン", "ゲーム", "スポーツ", "サッカー", "テニス",
    "ゴルフ", "ピアノ", "ギター", "コンサート", "パーティー", "プレゼント",
    "アルバイト", "ビジネス", "プロジェクト", "チーム", "グループ",
    "リスト", "ページ", "カード", "チケット", "シャツ", "ズボン", "クツ",
    "カバン", "メートル", "キロ", "グラム", "パーセント", "エネルギー",
    "アメリカ", "ヨーロッパ", "アジア", "フランス", "ドイツ", "イギリス",
    "イタリア", "スペイン", "ロシア", "インド", "カナダ",
    # round-4b growth: tech / modern life loanwords
    "スマートフォン", "タブレット", "アプリ", "ウェブ", "サイト",
    "ブログ", "ビデオ", "アニメ", "ドラマ", "デザイン", "イベント",
    "コンビニ", "スーパー", "デパート", "ビル", "マンション",
    "アパート", "エレベーター", "エスカレーター", "ロボット",
    "バッテリー", "エンジン", "ハンドル", "ガソリン", "ミルク",
    "チーズ", "バター", "チョコレート", "クッキー", "ピザ", "パスタ",
    "ハンバーガー", "サンドイッチ", "フォーク", "ナイフ", "スプーン",
    "コップ", "グラス", "ボトル", "メニュー", "ポケット", "ボタン",
    "ポスト", "バッグ", "ランチ", "ディナー", "パスワード",
    "アカウント", "ログイン", "ダウンロード", "キーボード", "マウス",
    "プリンター", "コピー", "レッスン", "クイズ", "レベル", "スコア",
    "メンバー", "リーダー", "コーチ", "ファン", "ステージ",
    "スクリーン", "カレンダー", "スケジュール", "アイデア", "イメージ",
    "スタイル", "タイプ", "ルール", "マナー", "チャンス", "ストレス",
    "アルゴリズム", "ライブラリ", "フレームワーク", "コード", "バグ",
    "リリース", "バージョン", "メモリ", "ディスク", "ベンチマーク",
]

_ADVERBS = [
    "すごく", "少し", "ちょっと", "たくさん", "もっと", "また",
    "まだ", "すぐ", "いつも", "時々", "よく", "あまり", "全然",
    "きっと", "たぶん", "やはり", "やっぱり", "一緒に", "ゆっくり",
    "はっきり", "しっかり", "そろそろ", "だんだん", "どんどん",
    "なかなか", "ほとんど", "必ず", "絶対", "突然", "急に",
    # round-4b growth
    "すっかり", "ずっと", "さっき", "やっと", "ついに", "いきなり",
    "たまに", "ほぼ", "およそ", "特に", "主に", "実は", "実際",
    "かなり", "ずいぶん", "とにかく", "どうぞ", "どうも", "もちろん",
    "しばらく", "さらに", "すでに", "もうすぐ", "いつか", "いつでも",
    "なるべく", "できるだけ", "わざと", "わざわざ", "偶然", "結局",
    "順番に", "初めて", "久しぶりに", "再び", "常に", "決して",
]

# もう gets a below-particle price: the decomposition も(助詞)+う(助動詞)
# costs 250 on the lattice and is never the right analysis
_CHEAP_ADVERBS = [("もう", 140), ("とても", 140)]
# とても joined もう here when the per-POS lattice exposed a cheaper
# (wrong) と+て+も particle chain at the adverb's old 450 price

_CONJUNCTIONS = ["そして", "しかし", "でも", "だから", "それで", "また",
                 "それから", "つまり", "例えば", "それに", "ところが",
                 "さて", "または", "あるいは", "ただし", "なぜなら",
                 "そこで", "すると", "ですから"]

_PRENOMINALS = ["この", "その", "あの", "どの", "大きな", "小さな", "同じ",
                "ある", "あらゆる", "いわゆる", "いろんな", "色んな"]

# (stem, class) — ichidan drops る; godan conjugates by final kana row;
# suru/kuru irregular listed explicitly below
_ICHIDAN = ["食べ", "見", "出", "寝", "起き", "着", "開け", "閉め", "教え",
            "覚え", "忘れ", "考え", "伝え", "感じ", "信じ", "調べ", "続け",
            "始め", "止め", "決め", "入れ", "届け", "受け", "助け", "逃げ",
            "投げ", "見せ", "乗せ", "任せ", "い", "でき", "生き", "着け",
            "借り", "持て", "出かけ", "遅れ", "疲れ", "見つけ", "増え",
            "まとめ", "覚め", "集め", "比べ", "見え", "聞こえ", "あげ",
            "くれ", "答え", "辞め", "別れ", "慣れ", "触れ", "晴れ",
            # round-4b growth
            "得", "与え", "迎え", "数え", "抱え", "超え", "越え", "燃え",
            "冷え", "消え", "植え", "載せ", "痩せ", "混ぜ", "当て",
            "捨て", "育て", "建て", "立て", "変え", "加え", "落ち",
            "付け", "片付け", "間違え", "着替え", "並べ", "曲げ",
            "下げ", "上げ", "挙げ", "避け", "預け", "勧め", "進め",
            "認め", "眺め", "褒め", "攻め", "責め", "温め", "確かめ"]

_GODAN = [  # (stem-without-final, final dictionary kana)
    ("書", "く"), ("行", "く"), ("聞", "く"), ("歩", "く"), ("働", "く"),
    ("泳", "ぐ"), ("急", "ぐ"), ("話", "す"), ("出", "す"), ("返", "す"),
    ("待", "つ"), ("持", "つ"), ("立", "つ"), ("勝", "つ"), ("死", "ぬ"),
    ("遊", "ぶ"), ("呼", "ぶ"), ("飛", "ぶ"), ("読", "む"), ("飲", "む"),
    ("住", "む"), ("休", "む"), ("頼", "む"), ("作", "る"), ("乗", "る"),
    ("取", "る"), ("帰", "る"), ("走", "る"), ("入", "る"), ("分か", "る"),
    ("終わ", "る"), ("始ま", "る"), ("売", "る"), ("降", "る"), ("曲が", "る"),
    ("買", "う"), ("会", "う"), ("使", "う"), ("思", "う"), ("言", "う"),
    ("習", "う"), ("歌", "う"), ("洗", "う"), ("笑", "う"), ("手伝", "う"),
    ("撮", "る"), ("咲", "く"), ("しま", "う"), ("通", "う"), ("送", "る"),
    ("閉ま", "る"), ("もら", "う"), ("置", "く"), ("消", "す"),
    ("向か", "う"), ("上が", "る"), ("下が", "る"), ("開", "く"),
    ("渡", "す"), ("届", "く"), ("探", "す"), ("学", "ぶ"), ("運", "ぶ"),
    ("光", "る"), ("間に合", "う"), ("思い出", "す"), ("動", "く"),
    ("並", "ぶ"), ("選", "ぶ"), ("残", "る"), ("直", "す"), ("写", "す"),
    ("移", "る"), ("戻", "る"), ("登", "る"), ("踊", "る"), ("怒", "る"),
    ("守", "る"), ("触", "る"), ("切", "る"), ("知", "る"), ("頑張", "る"),
    # round-4b growth
    ("願", "う"), ("祈", "る"), ("変わ", "る"), ("伝わ", "る"),
    ("集ま", "る"), ("決ま", "る"), ("止ま", "る"), ("泊ま", "る"),
    ("困", "る"), ("断", "る"), ("謝", "る"), ("払", "う"), ("拾", "う"),
    ("失", "う"), ("追", "う"), ("誘", "う"), ("迷", "う"), ("救", "う"),
    ("吸", "う"), ("違", "う"), ("飾", "る"), ("配", "る"), ("測", "る"),
    ("落と", "す"), ("起こ", "す"), ("起こ", "る"), ("回", "る"),
    ("回", "す"), ("押", "す"), ("引", "く"), ("弾", "く"), ("吹", "く"),
    ("拭", "く"), ("履", "く"), ("焼", "く"), ("磨", "く"), ("招", "く"),
    ("続", "く"), ("着", "く"), ("付", "く"), ("頂", "く"), ("驚", "く"),
    ("泣", "く"), ("鳴", "く"), ("抜", "く"), ("脱", "ぐ"), ("稼", "ぐ"),
    ("防", "ぐ"), ("指", "す"), ("差", "す"), ("示", "す"), ("試", "す"),
    ("貸", "す"), ("倒", "す"), ("離", "す"), ("育", "つ"), ("打", "つ"),
    ("拭", "う"), ("騒", "ぐ"), ("継", "ぐ"), ("注", "ぐ"), ("頼", "る"),
    ("飼", "う"),
    ("余", "る"), ("眠", "る"), ("刺", "す"), ("治", "す"), ("治", "る"),
    ("過ご", "す"), ("暮ら", "す"), ("増や", "す"), ("減ら", "す"),
    ("動か", "す"), ("驚か", "す"), ("鳴ら", "す"), ("冷や", "す"),
    ("飛ば", "す"), ("伸ば", "す"), ("乾か", "す"), ("沸か", "す"),
    ("減", "る"), ("太", "る"), ("痛", "む"), ("進", "む"), ("盗", "む"),
    ("畳", "む"), ("包", "む"), ("悩", "む"), ("喜", "ぶ"), ("転", "ぶ"),
    ("結", "ぶ"), ("叫", "ぶ"),
]

_I_ADJ_STEMS = ["大き", "小さ", "新し", "古", "高", "安", "良", "悪", "早",
                "遅", "暑", "寒", "熱", "冷た", "美し", "おいし", "うま",
                "難し", "易し", "面白", "楽し", "嬉し", "悲し", "忙し",
                "近", "遠", "長", "短", "強", "弱", "多", "少な", "白",
                "黒", "赤", "青", "明る", "暗", "若", "重", "軽", "涼し",
                "素晴らし", "広", "狭", "深", "浅", "速", "甘", "辛",
                "固", "柔らか", "優し", "厳し", "危な", "正し", "細か",
                # round-4b growth
                "珍し", "激し", "詳し", "親し", "懐かし", "恥ずかし",
                "羨まし", "貧し", "等し", "苦し", "眠", "痛", "汚",
                "賢", "鋭", "鈍", "太", "細", "薄", "厚", "硬",
                "温か", "暖か", "丸", "ぬる", "酸っぱ", "偉", "凄",
                "ひど", "かわい", "可愛", "欲し", "乏し", "険し",
                "めでた", "怪し", "幼", "醜", "尊", "清"]

# godan conjugation rows: final kana -> (a, i, e, o, onbin-ta-form)
# round-5 vocabulary scale-up: extended stems feed the SAME conjugation
# generators (lexicon_ja_ext.py holds pure vocabulary; dedup via `seen`)
from .lexicon_ja_ext import (GODAN_EXT as _GODAN_EXT,
                             GODAN_EXT2 as _GODAN_EXT2,
                             GODAN_EXT3 as _GODAN_EXT3,
                             ICHIDAN_EXT as _ICHIDAN_EXT,
                             ICHIDAN_EXT2 as _ICHIDAN_EXT2,
                             ICHIDAN_EXT3 as _ICHIDAN_EXT3,
                             I_ADJ_EXT as _I_ADJ_EXT)

_ICHIDAN = _ICHIDAN + _ICHIDAN_EXT + _ICHIDAN_EXT2 + _ICHIDAN_EXT3
from .lexicon_ja_ext import I_ADJ_EXT2 as _I_ADJ_EXT2

_I_ADJ_STEMS = _I_ADJ_STEMS + _I_ADJ_EXT + _I_ADJ_EXT2

_GODAN_ROWS = {
    "く": ("か", "き", "け", "こ", "いた"),
    "ぐ": ("が", "ぎ", "げ", "ご", "いだ"),
    "す": ("さ", "し", "せ", "そ", "した"),
    "つ": ("た", "ち", "て", "と", "った"),
    "ぬ": ("な", "に", "ね", "の", "んだ"),
    "ぶ": ("ば", "び", "べ", "ぼ", "んだ"),
    "む": ("ま", "み", "め", "も", "んだ"),
    "る": ("ら", "り", "れ", "ろ", "った"),
    "う": ("わ", "い", "え", "お", "った"),
}

_GODAN = _GODAN + [g for g in _GODAN_EXT + _GODAN_EXT2 + _GODAN_EXT3
                   if g[1] in _GODAN_ROWS]

_COSTS = {P: 100, AUX: 150, CONJ: 300, V: 350, N: 400, ADJ: 400, ADV: 450,
          PRE: 350}


def _verb_forms() -> List[Tuple[str, str, int]]:
    out = []
    seen = set()

    def add(surface, cost_bump=0):
        if surface and surface not in seen:
            seen.add(surface)
            out.append((surface, V, _COSTS[V] + cost_bump))

    for stem in _ICHIDAN:
        add(stem + "る")   # dictionary
        add(stem)          # 連用/未然 (combines with ます/た/ない/て)
        add(stem + "れ", 50)   # 仮定
        add(stem + "ろ", 80)   # imperative
    for stem, fin in _GODAN:
        a, i, e, o, onbin = _GODAN_ROWS[fin]
        add(stem + fin)        # dictionary 書く
        add(stem + i)          # 連用 書き (+ます)
        add(stem + a, 30)      # 未然 書か (+ない/れる)
        add(stem + e, 50)      # 仮定/命令 書け
        add(stem + o, 80)      # 意向 書こ (+う)
        add(stem + onbin[:-1], 20)  # 音便 stem 書い/読ん (+た/だ handled as AUX た/で)
        add(stem + onbin, 40)  # fused 書いた/読んだ as single verb token fallback
    # irregulars
    for f in ("する", "し", "さ", "すれ", "しろ", "せよ"):
        add(f)
    add("来る")
    add("来", 60)
    add("くる", 60)
    # kana 来る stems collide with everyday words (き=木/気, こ=子, これ the
    # pronoun) — priced well above them so they only win next to auxiliaries
    # when nothing else parses
    add("き", 300)
    add("こ", 400)
    return out


def _adj_forms() -> List[Tuple[str, str, int]]:
    out = []
    for stem in _I_ADJ_STEMS:
        out.append((stem + "い", ADJ, _COSTS[ADJ]))
        out.append((stem + "く", ADJ, _COSTS[ADJ] + 30))
        out.append((stem + "かっ", ADJ, _COSTS[ADJ] + 30))  # +た
        out.append((stem + "けれ", ADJ, _COSTS[ADJ] + 60))  # +ば
        out.append((stem + "さ", N, _COSTS[N] + 80))        # nominalization
    out.append(("いい", ADJ, _COSTS[ADJ]))
    out.append(("よく", ADJ, _COSTS[ADJ] + 30))
    return out


def build_lexicon() -> Dict[str, List[Tuple[str, int]]]:
    """surface -> [(pos, cost), ...] (a surface may be ambiguous, e.g. で as
    particle and auxiliary; の as particle and nominalizer)."""
    lex: Dict[str, List[Tuple[str, int]]] = {}

    def add(surface, pos, cost):
        lex.setdefault(surface, [])
        if all(p != pos for p, _ in lex[surface]):
            lex[surface].append((pos, cost))

    for w in _PARTICLES:
        add(w, P, _COSTS[P] + (len(w) - 1) * 20)
    for w in _AUXILIARIES:
        add(w, AUX, _COSTS[AUX] + (len(w) - 1) * 20)
    for w in _NOUNS:
        add(w, N, _COSTS[N])
    for w in _KATAKANA_NOUNS:
        # below the katakana unknown-run price (lattice._UNK_COST) so the
        # lexical analysis wins, but near it so unseen loanwords still parse
        add(w, N, _COSTS[N] + 100)
    from .lexicon_ja_ext import ADVERBS_EXT as _ADVERBS_EXT
    for w in _ADVERBS + _ADVERBS_EXT:
        add(w, ADV, _COSTS[ADV])
    for w, cost in _CHEAP_ADVERBS:
        add(w, ADV, cost)
    for w in _CONJUNCTIONS:
        add(w, CONJ, _COSTS[CONJ])
    for w in _PRENOMINALS:
        add(w, PRE, _COSTS[PRE])
    for w in _PREFIXES:
        # 接頭詞: priced between particles and nouns so お+噌 never beats a
        # lexicalized whole word (ご飯 stays ご飯) but お風呂 -> お/風呂
        add(w, "接頭詞", 320)
    for w in _MISC_VERBS:
        add(w, V, _COSTS[V])
    from .lexicon_ja_ext import INTERJECTIONS_EXT as _INTERJ_EXT
    for w in _INTERJECTIONS + _INTERJ_EXT:
        add(w, "感動詞", 300)
    for surface, pos, cost in _verb_forms():
        add(surface, pos, cost)
    for surface, pos, cost in _adj_forms():
        add(surface, pos, cost)

    # ---- round-5 vocabulary scale-up (lexicon_ja_ext.py): pure vocabulary
    # priced with the same scheme; the conjugation generators above already
    # consumed the ext verb/adjective stems (see the list extensions below
    # their definitions)
    from . import lexicon_ja_ext as ext  # noqa: the module-level import
    # above only pulls the stem lists; the vocabulary lists are read here

    for w in (ext.NOUNS_TIME + ext.NOUNS_PEOPLE + ext.NOUNS_BODY_HEALTH +
              ext.NOUNS_FOOD + ext.NOUNS_NATURE + ext.NOUNS_CITY_TRANSPORT +
              ext.NOUNS_ABSTRACT + ext.NOUNS_SOCIETY + ext.NOUNS_OBJECTS +
              ext.NOUNS_TECH + ext.NOUNS_SCHOOL_WORK +
              ext.NOUNS_EMOTION_COMM + ext.NOUNS_ARTS_SPORTS +
              ext.NOUNS_MISC_DAILY + ext.NOUNS_BUSINESS_LAW +
              ext.NOUNS_MEDIA_RELIGION_MIL + ext.NOUNS_AGRI_CRAFT +
              ext.NOUNS_WAVE2 + ext.NOUNS_WAVE4 + ext.NOUNS_WAVE5 +
              ext.NOUNS_WAVE6 + ext.NOUNS_WAVE7 + ext.NOUNS_WAVE8 +
              ext.NOUNS_WAVE9 + ext.NOUNS_WAVE10 + ext.NOUNS_WAVE13 +
              ext.NOUNS_WAVE14 + ext.NOUNS_WAVE15 + ext.NOUNS_WAVE16 +
              ext.NOUNS_WAVE17 + ext.NOUNS_WAVE18 + ext.NOUNS_WAVE19 +
              ext.NOUNS_WAVE20 + ext.NOUNS_WAVE21 + ext.YOJI_IDIOMS +
              ext.NOUNS_WAVE23 + ext.NOUNS_WAVE24 + ext.NOUNS_WAVE25 +
              ext.NOUNS_WAVE26 + ext.NOUNS_WAVE27 + ext.NOUNS_WAVE28 +
              ext.NOUNS_WAVE29 + ext.NOUNS_WAVE31 + ext.NOUNS_WAVE32 +
              ext.NOUNS_WAVE33 + ext.NOUNS_WAVE34 + ext.NOUNS_WAVE35 +
              ext.NOUNS_WAVE36 + ext.NOUNS_WAVE37 + ext.NOUNS_WAVE38):
        # +30 over the core (most-frequent) noun tier
        add(w, N, _COSTS[N] + 30)
    for w in ext.SURU_NOUNS + ext.SURU_NOUNS2 + ext.SURU_NOUNS3:
        add(w, N, _COSTS[N] + 10)
    for w in ext.NA_ADJ_STEMS + ext.NA_ADJ_STEMS2:
        add(w, N, _COSTS[N] + 30)
    for w in ext.KATAKANA_EXT + ext.KATAKANA_EXT2 + ext.KATAKANA_EXT3:
        add(w, N, _COSTS[N] + 100)  # same tier as the core katakana list
    for w in (ext.SURNAMES + ext.SURNAMES2 + ext.GIVEN_NAMES +
              ext.PLACES_JAPAN + ext.PLACES_JAPAN2 + ext.PLACES_WORLD):
        add(w, N, _COSTS[N] + 60)  # proper nouns: rarer a priori
    for w in ext.NUMBER_WORDS:
        add(w, N, _COSTS[N] + 20)
    for w in ("さん", "さま", "様", "くん", "君", "ちゃん", "氏", "殿",
              "たち", "達"):
        # 名詞-接尾 honorific/plural: must beat the verb-stem+auxiliary
        # analysis of さ+ん after a name (V+AUX connection is -250, so with
        # the +150 N,N connection these need to be VERY cheap — IPADic
        # likewise prices 接尾 far below content words). Overwrite any
        # dearer homograph from the core noun list
        lex[w] = [(p, min(c, 60) if p == N else c)
                  for p, c in lex.get(w, [])]
        if all(p != N for p, _ in lex[w]):
            lex[w].append((N, 60))
    for w in ext.KANJI_SUFFIXES:
        # Pricing (blind3/blind4 post-record fixes, PERF.md round 5; the
        # kanji unknown model is (1100, 500) -> runs price 1600/2100/2600):
        # a suffix must lose to the 2-kanji unknown price when its host is
        # ALSO unknown — at 540 the tier shredded unseen compounds (減税 ->
        # 減/税; first-pass blind3 F1 0.932). At 1400: lexicalized-host
        # splits win (研究(400)+者(1400)+conn(150) = 1950 << the 3-kanji
        # unknown 2600), numeral+counter splits stay under the 2-kanji
        # unknown (二(400)+階: 1950 < 2100), while 1-kanji-UNK+suffix
        # (1600+1400 = 3000) exceeds it, so fresh compounds stay whole
        add(w, N, 1400)
    for w in ext.KANJI_PREFIXES:
        # same bound from the prefix side: 超(1400)+伝導(2100) exceeds the
        # 3-kanji unknown 2600 (超伝導 stays whole) and prefix+suffix
        # pairs (新+型: 1400+1400-200 = 2600) clear the 2-kanji 2100
        add(w, "接頭詞", 1400)
    return lex
